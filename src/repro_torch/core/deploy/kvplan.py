"""KV memory plans: paged cache residency as a searchable genome.

The counterpart of ``src/repro/core/deploy/kvplan.py``: numpy, as there,
apart from :func:`measure_cache_error`, which runs the port's prefill.

The serving engine's decode caches are its dominant memory consumer — every
resident slot holds ``max_len`` tokens of per-layer K/V state.  This module
makes the *memory plan* for those caches a first-class genome alongside the
engine schedule:

* ``kv_page_size`` — caches are allocated in fixed pages of N tokens (the
  vLLM-style paged-attention layout), so residency is granted page-by-page
  instead of slot-by-slot;
* ``kv_dtype`` — cache pages store ``f32``, ``bf16``, or per-page max-abs
  scaled ``int8``.  Narrower pages buy more resident slots under the same
  byte budget at the cost of decode error;
* ``replicas`` — how many data-parallel engine replicas the router fans
  traffic over (each replica owns a row of the launch mesh).

:class:`KVPlan` resolves a genome into a concrete plan and models its byte
footprint: :meth:`KVPlan.effective_slots` clamps the engine schedule's
``max_slots`` to what the plan's pages actually fit in the modeled budget —
this is the coupling that makes (slots × page size × dtype × replicas) a
*joint* search problem rather than four independent knobs.

The codec here is a host-side numpy reference (the measured-error oracle),
not an accelerator kernel: :func:`quantize_pages` round-trips a
``(tokens, features)`` view of a cache tensor through the paged codec, and
:class:`PagedKVCache` is a bounded page-pool store whose reads are
bit-identical to the contiguous codec (the property the differential tests
pin).  Two error functionals matter:

* :func:`cache_error` — a deterministic *analytic bound* on the mean
  absolute decode error (relative to the tensor's RMS).  For ``int8`` it is
  the length-weighted mean of per-page quantization steps, which is
  provably monotone non-increasing under page refinement (splitting a page
  can only shrink sub-page scales) — the property
  ``tests/test_kvplan_props.py`` verifies.  This is the fitness objective.
* :func:`roundtrip_error` — the *measured* mean absolute error of an actual
  codec round trip.  Always ``<= cache_error`` (each element's error is at
  most half its page's step), which the tests also pin.

:func:`measure_cache_error` runs a real model prefill and round-trips the
resulting cache tensors through the codec — the quantized-cache error the
fitness gate (:data:`KV_ERROR_GATE`) constrains is measured on real
activations, not synthetic data.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# The KV-plan knobs merged into ``serve_schedule_space()`` (see
# ``engine.SERVE_SPACE``).  Page sizes are powers of two so any two plans'
# page partitions are nested — what makes the int8 error bound monotone.
KV_SPACE: dict[str, tuple] = {
    "kv_page_size": (4, 8, 16, 32),
    "kv_dtype": ("f32", "bf16", "int8"),
    "replicas": (1, 2, 4),
}
# The shipped default: full-precision pages, single replica — exactly the
# pre-plan engine behavior (no clamping, no quantization, no router).
DEFAULT_KV_PLAN: dict = {"kv_page_size": 16, "kv_dtype": "f32",
                         "replicas": 1}

DTYPE_BYTES = {"f32": 4, "bf16": 2, "int8": 1}
PAGE_SCALE_BYTES = 4            # one f32 max-abs scale per int8 page
TOKEN_BYTES_F32 = 256           # modeled per-token KV footprint at f32
KV_BUDGET_BYTES = 32 * 1024     # modeled per-replica cache byte budget

# Fitness gate on the cache decode-error objective: plans whose analytic
# error bound exceeds this are not deployable (``ParetoFront.select``'s
# ``limit`` in the sharded_serving suite).  int8 at the smallest page size
# sits ~5x under this on real prefill caches; the gate exists to reject
# pathological plans, while the error *objective* supplies the Pareto
# pressure toward full precision.
KV_ERROR_GATE = 0.05


@dataclass(frozen=True)
class KVPlan:
    """A resolved KV memory plan (one point in :data:`KV_SPACE`)."""

    page_size: int = 16
    dtype: str = "f32"
    replicas: int = 1

    def __post_init__(self):
        if self.page_size not in KV_SPACE["kv_page_size"]:
            raise ValueError(f"kv_page_size {self.page_size} not in "
                             f"{KV_SPACE['kv_page_size']}")
        if self.dtype not in KV_SPACE["kv_dtype"]:
            raise ValueError(f"kv_dtype {self.dtype!r} not in "
                             f"{KV_SPACE['kv_dtype']}")
        if self.replicas not in KV_SPACE["replicas"]:
            raise ValueError(f"replicas {self.replicas} not in "
                             f"{KV_SPACE['replicas']}")

    @classmethod
    def from_genome(cls, genome: dict) -> "KVPlan":
        """The plan a (possibly partial) serve genome prescribes — missing
        knobs take the shipped default, so engine-only genomes from older
        artifacts resolve to the identity plan."""
        g = dict(DEFAULT_KV_PLAN)
        g.update({k: genome[k] for k in KV_SPACE if k in genome})
        return cls(page_size=int(g["kv_page_size"]),
                   dtype=str(g["kv_dtype"]),
                   replicas=int(g["replicas"]))

    def to_genome(self) -> dict:
        return {"kv_page_size": self.page_size, "kv_dtype": self.dtype,
                "replicas": self.replicas}

    # -- modeled byte footprint -------------------------------------------
    def n_pages(self, max_len: int) -> int:
        return -(-int(max_len) // self.page_size)

    def page_bytes(self) -> int:
        data = self.page_size * TOKEN_BYTES_F32 * DTYPE_BYTES[self.dtype] \
            // DTYPE_BYTES["f32"]
        return data + (PAGE_SCALE_BYTES if self.dtype == "int8" else 0)

    def slot_bytes(self, max_len: int) -> int:
        """Modeled bytes one resident slot's pages occupy at ``max_len``."""
        return self.n_pages(max_len) * self.page_bytes()

    def effective_slots(self, max_slots: int, max_len: int,
                        budget: int = KV_BUDGET_BYTES) -> int:
        """The largest slot count ``<= max_slots`` whose paged caches fit
        the modeled byte budget (never below 1: a plan that cannot hold one
        sequence clamps rather than refusing traffic outright)."""
        sb = self.slot_bytes(max_len)
        fit = budget // sb if sb > 0 else max_slots
        return max(1, min(int(max_slots), int(fit)))


# --------------------------------------------------------------------------
# The paged codec (numpy reference; tokens axis first)
# --------------------------------------------------------------------------


def _bf16_round(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even truncation of f32 to the bf16 grid (kept in an
    f32 container — this is a numerics reference, not a storage format)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rounded = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
               ) & np.uint32(0xFFFF0000)
    return rounded.astype(np.uint32).view(np.float32).reshape(x.shape)


def _as_tokens(arr: np.ndarray) -> np.ndarray:
    """A ``(tokens, features)`` f32 view of a cache tensor."""
    a = np.asarray(arr, np.float32)
    return a.reshape(a.shape[0], -1) if a.ndim >= 2 else a.reshape(-1, 1)


def page_scales(arr: np.ndarray, page_size: int) -> np.ndarray:
    """Per-page int8 scales: ``max|page| / 127`` over runs of ``page_size``
    tokens (the trailing page may be short and is scaled over its actual
    tokens — the same convention :class:`PagedKVCache` seals with)."""
    a = _as_tokens(arr)
    n = a.shape[0]
    return np.array([np.max(np.abs(a[lo:lo + page_size])) / 127.0
                     for lo in range(0, n, page_size)], np.float32)


def quantize_pages(arr: np.ndarray, page_size: int, dtype: str
                   ) -> np.ndarray:
    """Round-trip a ``(tokens, ...)`` tensor through the paged cache codec:
    the contiguous reference every paged read must equal bit-for-bit."""
    a = _as_tokens(arr)
    if dtype == "f32":
        out = a.copy()
    elif dtype == "bf16":
        out = _bf16_round(a)
    elif dtype == "int8":
        out = np.empty_like(a)
        for lo in range(0, a.shape[0], page_size):
            page = a[lo:lo + page_size]
            s = float(np.max(np.abs(page))) / 127.0
            if s == 0.0:
                out[lo:lo + page_size] = 0.0
            else:
                q = np.clip(np.rint(page / s), -127, 127).astype(np.int8)
                out[lo:lo + page_size] = q.astype(np.float32) * s
    else:
        raise ValueError(f"unknown kv dtype {dtype!r}")
    return out.reshape(np.asarray(arr).shape)


def _rms(a: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def cache_error(arr: np.ndarray, page_size: int, dtype: str) -> float:
    """Analytic upper bound on the mean absolute decode error of the paged
    codec, relative to the tensor's RMS — the KV plan's fitness objective.

    ``int8``: the token-weighted mean of per-page half-steps
    ``s_p / 2``.  Because page boundaries at power-of-two sizes are nested,
    refining pages can only shrink sub-page scales, so this bound is
    monotone non-increasing in page count (``tests/test_kvplan_props.py``).
    ``bf16``: ``2**-8 * mean|x|`` — per element the RNE error is at most
    half an ulp, ``2**(e-8) <= 2**-8 * |x|`` for ``|x| >= 2**e`` (7
    explicit significand bits).  ``f32``: exactly 0.  All cases:
    ``roundtrip_error <= cache_error``.
    """
    a = _as_tokens(arr)
    rms = _rms(a)
    if rms == 0.0 or dtype == "f32":
        return 0.0
    if dtype == "bf16":
        return float(2.0 ** -8 * np.mean(np.abs(a)) / rms)
    if dtype == "int8":
        n = a.shape[0]
        scales = page_scales(a, page_size)
        lens = np.array([min(page_size, n - lo)
                         for lo in range(0, n, page_size)], np.float64)
        return float((lens * scales.astype(np.float64)).sum()
                     / lens.sum() / 2.0 / rms)
    raise ValueError(f"unknown kv dtype {dtype!r}")


def roundtrip_error(arr: np.ndarray, page_size: int, dtype: str) -> float:
    """Measured mean absolute codec error relative to RMS (``<=``
    :func:`cache_error` by construction)."""
    a = _as_tokens(arr)
    rms = _rms(a)
    if rms == 0.0:
        return 0.0
    rt = quantize_pages(a, page_size, dtype)
    return float(np.mean(np.abs(rt - a)) / rms)


# --------------------------------------------------------------------------
# Bounded paged store
# --------------------------------------------------------------------------


class PagedKVCache:
    """A bounded page-pool KV store (host-side reference implementation).

    Pages are fixed ``(page_size, dim)`` token blocks drawn from a shared
    free list of ``n_pages`` — residency is granted page-by-page, so the
    pool, not a per-slot allocation, is what runs out.  Rows append raw
    (f32); a page is *sealed* (encoded at the plan dtype) the moment it
    fills, and a partial trailing page is encoded over its filled rows at
    read time — exactly the :func:`quantize_pages` chunking, which is what
    makes paged reads equal contiguous reads bit-for-bit."""

    def __init__(self, *, n_pages: int, page_size: int, dim: int,
                 dtype: str = "f32"):
        if dtype not in DTYPE_BYTES:
            raise ValueError(f"unknown kv dtype {dtype!r}")
        if n_pages < 1 or page_size < 1 or dim < 1:
            raise ValueError("n_pages, page_size and dim must be >= 1")
        self.page_size = page_size
        self.dim = dim
        self.dtype = dtype
        self._free: list[int] = list(range(n_pages))
        self._raw: dict[int, np.ndarray] = {}       # page id -> (P, dim) f32
        self._fill: dict[int, int] = {}             # page id -> rows filled
        self._seqs: dict[str, list[int]] = {}       # uid -> page ids

    @property
    def n_free_pages(self) -> int:
        return len(self._free)

    def allocate(self, uid: str) -> None:
        if uid in self._seqs:
            raise ValueError(f"sequence {uid!r} already allocated")
        self._seqs[uid] = []

    def append(self, uid: str, row: np.ndarray) -> bool:
        """Append one token's vector.  Returns False (and stores nothing)
        when a new page is needed and the pool is exhausted."""
        pages = self._seqs[uid]
        if not pages or self._fill[pages[-1]] == self.page_size:
            if not self._free:
                return False
            pid = self._free.pop()
            pages.append(pid)
            self._raw[pid] = np.zeros((self.page_size, self.dim),
                                      np.float32)
            self._fill[pid] = 0
        pid = pages[-1]
        self._raw[pid][self._fill[pid]] = np.asarray(row, np.float32)
        self._fill[pid] += 1
        return True

    def _decode_page(self, pid: int) -> np.ndarray:
        filled = self._raw[pid][:self._fill[pid]]
        return quantize_pages(filled, self.page_size, self.dtype)

    def read(self, uid: str) -> np.ndarray:
        """The sequence's decoded ``(n, dim)`` history — bit-identical to
        ``quantize_pages`` of the contiguously-stored rows."""
        pages = self._seqs[uid]
        if not pages:
            return np.zeros((0, self.dim), np.float32)
        return np.concatenate([self._decode_page(p) for p in pages])

    def n_tokens(self, uid: str) -> int:
        return sum(self._fill[p] for p in self._seqs[uid])

    def free(self, uid: str) -> None:
        for pid in self._seqs.pop(uid):
            self._raw.pop(pid, None)
            self._fill.pop(pid, None)
            self._free.append(pid)


# --------------------------------------------------------------------------
# Measured error on real model caches
# --------------------------------------------------------------------------


def measure_cache_error(cfg, params, plan: KVPlan,
                        prompts: np.ndarray) -> dict:
    """Round-trip a real prefill's cache tensors through the plan's paged
    codec: the quantized-cache decode error the fitness gate constrains,
    measured on actual model activations.

    Returns ``{"measured", "bound", "n_leaves"}`` where ``measured`` is the
    worst per-leaf :func:`roundtrip_error` (one leaf routed through a live
    :class:`PagedKVCache` to keep the store on the measured path) and
    ``bound`` the worst per-leaf :func:`cache_error`.  The prefill is the
    port's, on the device ``params`` live on."""
    import torch

    from ...models.transformer import prefill

    prompts = np.asarray(prompts, np.int32)
    B, P = prompts.shape
    pos = np.broadcast_to(np.arange(P, dtype=np.int32)[None], (B, P))
    batch = {"tokens": prompts, "positions": pos}
    if cfg.mrope:
        batch["positions3"] = np.broadcast_to(pos[:, :, None], (B, P, 3))
    _, caches = prefill(params, batch, cfg)

    views = []
    for name in sorted(caches):
        leaf = caches[name]
        if not leaf.is_floating_point():
            continue
        a = leaf.to(torch.float32).cpu().numpy()
        if a.ndim >= 3 and a.shape[2] == P:
            # token-indexed leaf: page over the sequence axis
            views.append(np.moveaxis(a, 2, 0).reshape(P, -1))
        else:
            # recurrent state (conv/ssm): a single-page residual
            views.append(a.reshape(1, -1))
    if not views:
        return {"measured": 0.0, "bound": 0.0, "n_leaves": 0}

    measured = max(roundtrip_error(v, plan.page_size, plan.dtype)
                   for v in views)
    bound = max(cache_error(v, plan.page_size, plan.dtype) for v in views)

    # route the widest token-indexed leaf through the live paged store and
    # hold it to the contiguous codec — the store is part of what's measured
    tok_views = [v for v in views if v.shape[0] == P]
    if tok_views:
        v = max(tok_views, key=lambda x: x.shape[1])
        store = PagedKVCache(n_pages=plan.n_pages(P), dim=v.shape[1],
                             page_size=plan.page_size, dtype=plan.dtype)
        store.allocate("probe")
        for row in v:
            assert store.append("probe", row)
        got = store.read("probe")
        want = quantize_pages(v, plan.page_size, plan.dtype)
        if not np.array_equal(got, want):
            raise AssertionError("paged store diverged from the "
                                 "contiguous codec on a real cache leaf")
    return {"measured": measured, "bound": bound, "n_leaves": len(views)}
