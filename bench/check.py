"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample
drawn from the seed of the requests the window finished (the longest of
them always in it) is run once through the plain float32 reference
(``bench/reference/``): each prompt followed by the tokens the program
served for it.  At every served token's position the reference gives a
logit row; the number compared is the widest gap by which a served
token's logit lies below the reference's best in its row.  A correct
greedy server serves the reference's best token up to near-ties that
rounding flips, so its widest gap is small; a wrong cache, position,
routing or kernel puts tokens far below the best.

The control is the reference computed one precision step below the
served bf16 (``quant="fp8"``) put in the program's place: at each of the
same positions, the token the lower precision puts first, judged by the
same number (``control_gap``).
"""
from __future__ import annotations

import importlib
import math

import numpy as np
import torch

from bench.counts import Dims


def sample(finished: list, seed: int, served_tokens: int,
           requests: int) -> list:
    """Requests (objects with ``tokens`` and ``generated``) drawn from the
    seed: the one with the most positions first, then others in the
    seed's order until they are ``requests`` or more and hold
    ``served_tokens`` served tokens or more (all of them where the window
    finished fewer)."""
    pool = [r for r in finished if len(r.generated) >= 1]
    if not pool:
        return []
    pool.sort(key=lambda r: (r.tokens.size + len(r.generated), -r.rid),
              reverse=True)
    out = [pool[0]]
    rng = np.random.default_rng([seed, 0xc4ec])
    for i in rng.permutation(len(pool) - 1) + 1:
        if (len(out) >= requests
                and sum(len(r.generated) for r in out) >= served_tokens):
            break
        out.append(pool[int(i)])
    return out


def reference_module(config: dict):
    return importlib.import_module(f"bench.reference.{config['reference']}")


def sequences(reqs: list, device) -> tuple[list[torch.Tensor], list[int]]:
    """Each request's prompt and served tokens but the last (the input
    that predicts every served token), and its count of served tokens."""
    seqs = [torch.from_numpy(np.concatenate(
        [r.tokens, np.asarray(r.generated[:-1], np.int32)])).to(device)
        for r in reqs]
    return seqs, [len(r.generated) for r in reqs]


def gaps(ref_rows: list[torch.Tensor], picked: list) -> np.ndarray:
    """max(row) - row[token] at every position: ``picked[i]`` the tokens
    judged in ``ref_rows[i]``'s rows."""
    out = []
    for rows, toks in zip(ref_rows, picked):
        idx = torch.as_tensor(np.asarray(toks, np.int64), device=rows.device)
        got = rows.gather(1, idx[:, None])[:, 0]
        out.append((rows.max(dim=1).values - got).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def judge(params: dict, config: dict, reqs: list, *,
          control: bool = False) -> dict:
    """Run the reference over ``reqs``; returns the widest gap of the served
    tokens (``gap``) and, with ``control``, that of the fp8 reference's
    first choices (``control_gap``), with the counts behind them."""
    if not reqs:                        # nothing finished: nothing passes
        return {**_summary(np.zeros(0)), "requests": 0, "finite": True,
                **({f"control_{k}": v for k, v in
                    _summary(np.zeros(0)).items()} if control else {})}
    ref = reference_module(config)
    m = Dims.from_config(config)
    dev = params["embed"].device
    theta, eps = float(config["rope_theta"]), float(config["rms_norm_eps"])
    seqs, keep = sequences(reqs, dev)
    with torch.no_grad():
        rows = ref.logits(params, m, theta, eps, seqs, keep)
        out = {**_summary(gaps(rows, [r.generated for r in reqs])),
               "requests": len(reqs),
               "finite": bool(all(torch.isfinite(r).all() for r in rows))}
        if control:
            low = ref.logits(params, m, theta, eps, seqs, keep, quant="fp8")
            first = [r.argmax(dim=1).cpu().numpy() for r in low]
            out.update({f"control_{k}": v for k, v in
                        _summary(gaps(rows, first)).items()})
    return out


def _summary(g: np.ndarray) -> dict:
    """The widest gap, and how the gaps spread: the share of positions
    whose token is not the reference's best, the mean and the 99th
    percentile."""
    if not g.size:
        return {"gap": math.nan, "positions": 0, "flipped": 0,
                "flip_share": math.nan, "gap_mean": math.nan,
                "gap_p99": math.nan}
    return {"gap": float(g.max()), "positions": int(g.size),
            "flipped": int((g > 0).sum()),
            "flip_share": float((g > 0).mean()),
            "gap_mean": float(g.mean()),
            "gap_p99": float(np.percentile(g, 99))}
