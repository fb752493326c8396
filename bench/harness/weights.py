"""Weights made on the device from ``--seed``, the same for the program
and for the plain reference.

A reference module lists its parameters (``param_specs``): name, shape,
the dtype they are stored in, and how each is drawn: ``("normal", fan_in)``
(a standard normal over the square root of ``fan_in``), ``("const", v)``,
``("log_arange", n)`` (each row ``log(1..n)``, mamba's ``A_log``) or
``("tied", other)`` (the transpose of the parameter ``other``, listed
before it: a head tied to the embedding).  The normal draws come from one
``torch.Generator`` on the device, a large block at a time, in the order
of the list.
"""

from __future__ import annotations

import math

from . import seeds

BLOCK = 1 << 28      # normal draws a call


def _dtype(torch, name: str):
    return getattr(torch, name)


def make(specs, seed: int, device, block: int = BLOCK) -> dict:
    """name -> tensor in its stored dtype, on ``device``."""
    import torch
    gen = torch.Generator(device=device).manual_seed(
        seeds.stream(seed, "weights"))
    need = sum(math.prod(shape) for _, shape, _, init in specs
               if init[0] == "normal")
    out, buf, at = {}, None, 0
    for name, shape, dtype, init in specs:
        dt = _dtype(torch, dtype)
        n = math.prod(shape)
        if init[0] == "normal":
            parts = []
            while n:
                if buf is None or at == buf.numel():
                    buf = torch.randn(min(block, need), generator=gen,
                                      device=device)
                    need -= buf.numel()
                    at = 0
                take = min(n, buf.numel() - at)
                parts.append(buf[at:at + take])
                at += take
                n -= take
            flat = parts[0] if len(parts) == 1 else torch.cat(parts)
            out[name] = (flat.reshape(shape)
                         / math.sqrt(init[1])).to(dt)
        elif init[0] == "const":
            out[name] = torch.full(shape, float(init[1]), dtype=dt,
                                   device=device)
        elif init[0] == "tied":    # the transpose of a drawn matrix
            out[name] = out[init[1]].t().contiguous()
        elif init[0] == "log_arange":
            row = torch.log(torch.arange(1, init[1] + 1, dtype=torch.float32,
                                         device=device))
            out[name] = row.expand(shape).to(dt).contiguous()
        else:
            raise ValueError(f"{name}: unknown init {init!r}")
    return out


def check_skeleton(model, specs) -> None:
    """Raise unless the program's parameters are the reference's list:
    the same names, shapes and stored dtypes."""
    have = {n: (tuple(p.shape), str(p.dtype).removeprefix("torch."))
            for n, p in model.named_parameters()}
    want = {n: (tuple(s), d) for n, s, d, _ in specs}
    if have != want:
        diff = sorted(set(have.items()) ^ set(want.items()))[:8]
        raise ValueError(f"the program's parameters differ from the "
                         f"reference's list: {diff}")


def load_into(model, values: dict) -> None:
    """Copy ``values`` into the program's parameters, in place."""
    import torch
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(values[n])
