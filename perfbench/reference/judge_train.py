"""The comparison that decides ``correct`` for a training cell.

The plain reference (``reference/vqgan_train.py``) follows the checked
steps from the same seeded weights on the same batches and windows, with
dropout's masks drawn by the program's rule from its seed. For each side
(the program's readings, or a reference run put in its place) the readings
against the fp32 reference:

- ``loss_gap``: the largest relative gap of a step's generator or
  discriminator loss;
- ``grad_gap``: the worst leaf's gap between the norms of its first gradient
  as the optimizer got it, over the reference's norm of that leaf or of the
  median leaf, whichever is larger;
- ``change_gap``: the same for each leaf's change after the checked steps,
  codebook buffers included; a parameter whose reference gradient is under a
  thousandth of the median leaf's moves by round-off alone under Adam and is
  left out, and so is, inside a leaf, an element whose reference gradient is
  under a thousandth of the leaf's RMS element (Adam's first step moves it by
  the full learning rate, of the sign its round-off happens to take).
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, List, Optional

import torch

from perfbench import weights
from perfbench.reference.vqgan_train import TrainReference

EXCLUDE_BELOW = 1e-3  # of the median leaf's first-gradient norm; of a leaf's RMS gradient element


def on_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """fp32 copies on the host, made in one transfer."""
    names = sorted(tensors)
    if not names:
        return {}
    flat = torch.cat([tensors[k].detach().float().reshape(-1) for k in names]).cpu()
    return dict(zip(names, flat.split([tensors[k].numel() for k in names])))


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = sorted(tensors)
    if not names:
        return {}
    return dict(zip(names, torch.stack([torch.linalg.vector_norm(tensors[k].float()) for k in names]).tolist()))


def follow(spec, config: dict, device, batches: List[dict], precision: str = "fp32",
           rows: Optional[int] = None) -> dict:
    """The reference's readings over the checked steps; ``rows`` keeps only
    the first rows of each batch (the fault "half of the batch left out").
    ``change`` and ``grad`` hold each leaf's change and first gradient, on
    the host."""
    W = weights.make(spec, config["weight_seed"], device, config.get("overrides"))
    ref = TrainReference(W, config["program"], precision)
    losses = []
    for b in batches:
        sl = slice(None) if rows is None else slice(0, rows)
        losses.append(ref.step(b["mel"][sl], b["mel_length"][sl], b["wav"][sl], b["starts"][sl]))
    return {"losses": losses, "first_grad": norms(ref.first_grads), "grad": on_host(ref.first_grads),
            "change": on_host({k: ref.W[k].detach() - W[k] for k, _ in spec})}


def change_norms(change: Dict[str, torch.Tensor], ref: dict, keys) -> Dict[str, float]:
    """Each leaf's change norm over its elements whose first gradient in the
    reference is at least ``EXCLUDE_BELOW`` of the leaf's RMS element: an
    element whose gradient is round-off takes a full Adam step of either
    sign. A codebook buffer, which takes no gradient, counts whole."""
    out = {}
    for k in keys:
        c, g = change.get(k), ref["grad"].get(k)
        if c is None:
            out[k] = 0.0
            continue
        if g is not None:
            c = c[g.abs() >= EXCLUDE_BELOW * torch.sqrt(torch.mean(g * g))]
        out[k] = float(torch.linalg.vector_norm(c))
    return out


def _leaf_gap(side: Dict[str, float], ref: Dict[str, float], keys) -> float:
    keys = list(keys)
    median = statistics.median(ref[k] for k in keys)
    return max(abs(side.get(k, 0.0) - ref[k]) / max(ref[k], median) for k in keys)


def compare(side: dict, ref: dict) -> Dict[str, float]:
    loss_gap = max(abs(s[k] - r[k]) / abs(r[k]) for s, r in zip(side["losses"], ref["losses"]) for k in r)
    grads = ref["first_grad"]
    median_grad = statistics.median(grads.values())
    moving = [k for k in ref["change"] if k not in grads or grads[k] >= EXCLUDE_BELOW * median_grad]
    return {"loss_gap": loss_gap, "grad_gap": _leaf_gap(side["first_grad"], grads, grads),
            "change_gap": _leaf_gap(change_norms(side["change"], ref, moving),
                                    change_norms(ref["change"], ref, moving), moving)}


def worst(side: dict, ref: dict, n: int = 3) -> dict:
    """The leaves that set ``grad_gap`` and ``change_gap``, worst first, with
    both norms and the reference's first-gradient norm."""
    keys = list(ref["change"])
    pairs = {"first_grad": (side["first_grad"], ref["first_grad"]),
             "change": (change_norms(side["change"], ref, keys), change_norms(ref["change"], ref, keys))}
    out = {}
    for key, (s, r) in pairs.items():
        median = statistics.median(r.values())
        gaps = sorted(((abs(s.get(k, 0.0) - r[k]) / max(r[k], median), k) for k in r), reverse=True)[:n]
        out[key] = [[k, g, s.get(k), r[k], ref["first_grad"].get(k)] for g, k in gaps]
    return out


def judge(spec, config: dict, device, batches: List[dict], sides: List[dict]) -> Dict[str, float]:
    """Each number's worst over the program's runs of the checked steps
    (the set-up's, and the one after the window), all against one run of the
    reference."""
    ref = follow(spec, config, device, batches)
    readings = [compare(side, ref) for side in sides]
    for side, r in zip(sides, readings):  # what sets each number, for whoever reads a run that failed
        print(f"checked steps: {r}; worst leaves {worst(side, ref, 2)}", file=sys.stderr)
    return {k: max(r[k] for r in readings) for k in readings[0]}
