"""Model FLOPs from a configuration file's sizes (its ``port`` block: the
port's ``ModelConfig`` fields, which the published keys are checked
against in ``bench/tests``).

A token's forward pass costs two FLOPs a weight of every matrix product it
goes through (the projections, the MLP, mamba's in/x/dt/out projections
and the vocabulary head), and attention two products of the head size a
(query, key) pair the causal mask keeps, over the query heads.  Training
costs three forward passes (the backward's two products a forward one).
Elementwise work (norms, the conv, the scan's recurrence, softmax) is not
counted: it is no model FLOP, and the kernels' own counts
(``harness/costs.py``) price the scan and the norms.
"""

from __future__ import annotations

from .costs import _causal_pairs


def dims(port: dict) -> dict:
    d = port["d_model"]
    out = {"L": port["n_layers"], "d": d, "V": port["vocab"]}
    if port["family"] == "ssm":
        di = port.get("ssm_expand", 2) * d
        out.update(di=di, n=port["ssm_state"], R=-(-d // 16))
    else:
        H = port["n_heads"]
        out.update(H=H, K=port["n_kv_heads"],
                   hd=port.get("head_dim") or d // H, ff=port["d_ff"])
    return out


def layer_weights(port: dict) -> int:
    """Weights of the matrix products of one layer."""
    g = dims(port)
    d = g["d"]
    if port["family"] == "ssm":
        di, n, R = g["di"], g["n"], g["R"]
        return d * 2 * di + di * (R + 2 * n) + R * di + di * d
    H, K, hd, ff = g["H"], g["K"], g["hd"], g["ff"]
    return d * H * hd + 2 * d * K * hd + H * hd * d + 3 * d * ff


def _attention(port: dict, pairs: int) -> int:
    if port["family"] == "ssm":
        return 0
    g = dims(port)
    return g["L"] * 4 * g["hd"] * g["H"] * pairs


def forward(port: dict, S: int, head_rows: int) -> int:
    """One sequence of S tokens from an empty cache, the head on
    ``head_rows`` of its positions."""
    g = dims(port)
    return (2 * g["L"] * layer_weights(port) * S
            + _attention(port, _causal_pairs(S, S))
            + 2 * g["d"] * g["V"] * head_rows)


def train_step(port: dict, batch: int, seq: int) -> int:
    return 3 * batch * forward(port, seq, seq)


def prefill(port: dict, prompt: int) -> int:
    """A prompt's prefill: the head on its last position only."""
    return forward(port, prompt, 1)


def decode(port: dict, index: int) -> int:
    """One decoded token at cache length ``index``: it attends to the
    ``index + 1`` positions up to and including its own."""
    g = dims(port)
    return (2 * g["L"] * layer_weights(port) + _attention(port, index + 1)
            + 2 * g["d"] * g["V"])


def served(port: dict, prompt: int, answer: int) -> int:
    """A request's model FLOPs: its prefill (which yields the first token)
    and the decode steps of the other ``answer - 1`` tokens."""
    return prefill(port, prompt) + sum(decode(port, prompt + j)
                                       for j in range(answer - 1))
