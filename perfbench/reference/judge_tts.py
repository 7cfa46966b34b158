"""The comparison that decides ``correct`` for a served TTS model.

For each sampled request the plain reference (``reference/tts.py``) is run
once over its text with the run's served "tokens": the rounded durations
and each stage's codewords, at the frame bucket its batch had. The readings:

- ``dur_gap``: frames by which the reference's duration (clamped at 0) lies
  outside the rounding interval of the served duration, worst phone of every
  request of the pool (the duration head is cheap to follow, and a
  lower precision moves a rounding only where a phone lies near a
  half-frame: thousands of phones are needed to meet some);
- ``snap_gap``: how much farther the served codeword lies than the
  reference's nearest, over the scale of the distance
  (``|x|^2 + |e|^2``), worst frame, head and stage;
- ``code_err``: how far a served stage output lies from the codeword it
  names (an exact copy: 0);
- ``wav_err``: the largest absolute difference between the waveform the
  client got and the reference's, decoded from the served tokens;
- ``len_mismatch``: requests whose frame total or waveform length is not
  the reference's;
- ``missing``: sampled requests with no answer, and pool requests whose
  durations were never served.

The driver draws the sample and the pool from the seed among the requests
sent in the whole window.

With ``control=True`` the reference computed in TF32 takes the program's
place: teacher-forced by the same served tokens, its own choices (its
rounding, its nearest codeword) are read against the fp32 reference, and
its waveform against the fp32 one.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import numpy as np
import torch

from perfbench.reference.tts import Reference, decoder_ratio

BLOCK = 8  # requests the reference decodes at once


def _dur_gap(dur, choice, n):
    c = torch.clamp(dur[:n], min=0.0)
    return float(torch.clamp((c - choice[:n]).abs() - 0.5, min=0.0).max()) if n else 0.0


def _snap_gap(stage, choice):
    dist, scale = stage["dist"], stage["scale"]
    best = torch.argmin(dist, dim=-1, keepdim=True)
    gap = (torch.gather(dist, -1, choice[..., None].long()) - torch.gather(dist, -1, best))
    return float((gap / torch.gather(scale, -1, best)).max())


def _padded(texts, rids, Lt, device):
    S = texts[rids[0]].shape[1]
    text = torch.zeros((len(rids), Lt, S), dtype=torch.long, device=device)
    for b, r in enumerate(rids):
        text[b, : len(texts[r])] = torch.as_tensor(texts[r], device=device)
    return text, torch.as_tensor([len(texts[r]) for r in rids], device=device)


@torch.no_grad()
def judge(W: Dict[str, torch.Tensor], task: dict, engine: dict, texts: Dict[int, np.ndarray],
          served: Dict[int, dict], durs: Dict[int, np.ndarray], control: bool = False) -> Dict[str, float]:
    """``texts``: the pool's and the sample's requests; ``durs``: the
    durations served to them; ``served``: the sample's outputs (durations,
    frame total, stage outputs, the client's waveform)."""
    device = next(iter(W.values())).device
    ref = Reference(W, task, "fp32")
    low = Reference(W, task, "tf32") if control else None
    ratio = decoder_ratio(task)
    Lt, cap = engine["text_length"], engine["max_frames"]
    out = {"dur_gap": 0.0, "snap_gap": 0.0, "code_err": 0.0, "wav_err": 0.0, "len_mismatch": 0, "missing": 0}
    have = [r for r in sorted(texts) if durs.get(r) is not None]
    out["missing"] += len(texts) - len(have)
    for i in range(0, len(have), 4 * BLOCK):
        rids = have[i : i + 4 * BLOCK]
        text, tl = _padded(texts, rids, Lt, device)
        dur = ref.durations(*ref.encode_text(text, tl))
        if control:
            mask = (torch.arange(Lt, device=device)[None] < tl[:, None]).float()
            choice = torch.round(torch.clamp(low.durations(*low.encode_text(text, tl)), min=0.0)) * mask
        else:
            choice = torch.stack([torch.as_tensor(np.asarray(durs[r], np.float32)[:Lt], device=device) for r in rids])
        for b, r in enumerate(rids):
            out["dur_gap"] = max(out["dur_gap"], _dur_gap(dur[b], choice[b], int(tl[b])))
    complete = lambda s: all(k in s for k in ("dur", "total", "feat", "wav"))
    by_frames = defaultdict(list)
    for rid in sorted(served):
        s = served[rid]
        if not complete(s):
            out["missing"] += 1
            continue
        by_frames[int(s["feat"][-1].shape[0])].append(rid)
    for frames, rids in sorted(by_frames.items()):
        for i in range(0, len(rids), BLOCK):
            block = rids[i : i + BLOCK]
            text, tl = _padded(texts, block, Lt, device)
            dur = torch.stack([torch.as_tensor(np.asarray(served[r]["dur"], np.float32)[:Lt], device=device)
                               for r in block])
            feats = [torch.stack([served[r]["feat"][j].to(device).float() for r in block])
                     for j in range(len(served[block[0]]["feat"]))]
            idx = []
            for j, f in enumerate(feats):
                k = torch.argmin(ref.distances(f, j)[0], dim=-1)
                out["code_err"] = max(out["code_err"], float((f - ref.lookup(k, j)).abs().max()))
                idx.append(k)
            r32 = ref.forward(text, tl, frames, cap, dur, idx)
            if control:
                rlo = low.forward(text, tl, frames, cap, dur, idx)
                idx_choice = [torch.argmin(s["dist"], dim=-1) for s in rlo["stages"]]
                wavs = rlo["wav"]
            else:
                idx_choice = idx
                wavs = [torch.as_tensor(np.asarray(served[r]["wav"], np.float32), device=device) for r in block]
            for b, r in enumerate(block):
                for j, stage in enumerate(r32["stages"]):
                    one = {k: stage[k][b : b + 1] for k in ("dist", "scale")}
                    out["snap_gap"] = max(out["snap_gap"], _snap_gap(one, idx_choice[j][b : b + 1]))
                want = r32["wav"][b]
                total = int(r32["total"][b])
                if (not control and int(served[r]["total"]) != total) or wavs[b].shape[0] != want.shape[0] \
                        or want.shape[0] != total * ratio:
                    out["len_mismatch"] += 1
                    continue
                out["wav_err"] = max(out["wav_err"], float((wavs[b] - want).abs().max()) if total else 0.0)
    return out
