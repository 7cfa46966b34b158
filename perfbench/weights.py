"""Seeded weights, drawn on the device in a few large calls.

The benchmark makes every parameter and codebook itself, from the
configuration's ``weight_seed``, and hands the same tensors to the program
(``load_state_dict``) and to the plain reference. The names and shapes are
those of the program's state dicts (the published module names); the values
are the benchmark's:

- a weight-norm gain (``*.weight_g``) ~ U(0.5, 1.5): unit-scale kernels, so
  that the seeded HiFi-GAN's waveform is O(0.1) and an error in absolute
  terms means something;
- any other tensor of two or more dimensions ~ N(0, 1 / fan_in), fan_in
  being the elements of one output row;
- a codebook (``*.embed``) ~ N(0, 1), with ``embed_avg`` equal to it and
  ``cluster_size`` zero, as a codebook at the start of training;
- a bias ~ N(0, 0.02^2) and a LayerNorm scale 1 + N(0, 0.02^2), so that
  every bias and scale is read;
- ``overrides`` set named tensors to a constant: the duration head's bias,
  which gives a freshly drawn predictor a realistic number of frames a phone.

Every normal draw is one slice of a single ``torch.randn`` over all of them,
and every gain one slice of a single ``torch.rand``, in name order.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

Spec = Iterable[Tuple[str, Tuple[int, ...]]]


def spec_of(modules: Dict[str, torch.nn.Module]) -> list:
    """[(prefix.name, shape)] of every persistent float tensor of the
    modules' state dicts, sorted by name."""
    out = []
    for prefix, module in modules.items():
        for name, t in module.state_dict().items():
            if t.is_floating_point():
                out.append((f"{prefix}.{name}", tuple(t.shape)))
    return sorted(out)


def _kind(name: str) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight_g":
        return "gain"
    if leaf == "cluster_size":
        return "zero"
    if leaf == "embed_avg":
        return "copy"
    if leaf == "embed":
        return "codebook"
    return leaf


def make(spec: Spec, seed: int, device, overrides: Dict[str, float] = None) -> Dict[str, torch.Tensor]:
    """The weight dict of ``spec`` drawn from ``seed`` on ``device``."""
    spec = sorted(spec)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n_normal = sum(math.prod(s) for n, s in spec if _kind(n) not in ("gain", "zero", "copy"))
    n_gain = sum(math.prod(s) for n, s in spec if _kind(n) == "gain")
    normal = torch.randn(n_normal, generator=gen, device=device)
    gain = torch.rand(n_gain, generator=gen, device=device) + 0.5
    W, i, j = {}, 0, 0
    for name, shape in spec:
        n, kind = math.prod(shape), _kind(name)
        if kind == "gain":
            W[name] = gain[j : j + n].view(shape)
            j += n
            continue
        if kind in ("zero", "copy"):
            W[name] = torch.zeros(shape, device=device)
            continue
        z = normal[i : i + n].view(shape)
        i += n
        if kind == "codebook":
            W[name] = z
        elif len(shape) >= 2:
            W[name] = z * (n // shape[0]) ** -0.5
        elif kind == "bias":
            W[name] = z * 0.02
        else:  # a LayerNorm scale
            W[name] = 1.0 + z * 0.02
    for name, shape in spec:
        if _kind(name) == "copy":
            W[name] = W[name[: -len("_avg")]].clone()
    for name, value in (overrides or {}).items():
        W[name] = torch.full_like(W[name], float(value))
    return W


def load(modules: Dict[str, torch.nn.Module], W: Dict[str, torch.Tensor]) -> None:
    """Copy ``W`` into the modules (strict: every name must match), so the
    program keeps its own storage and re-derives what it derives on load."""
    for prefix, module in modules.items():
        head = prefix + "."
        state = module.state_dict()
        state.update({k[len(head):]: v for k, v in W.items() if k.startswith(head)})
        module.load_state_dict(state, strict=True)
