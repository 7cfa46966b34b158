"""What each rank runs in ``tests/test_torch_parallel.py``,
``tests/test_torch_am_train.py`` and ``tests/test_torch_emb_train.py``.

The ranks are fresh processes (``msmctts_tpu_torch.parallel.launch.run_ranks``)
that import this module to find their function, so it imports torch and the
port only: the JAX side of every comparison stays in the test process.
Inputs and results cross the process boundary as numpy arrays.
"""

import numpy as np
import torch

from msmctts_tpu_torch import weights as W
from msmctts_tpu_torch.config import Config, component_kwargs
from msmctts_tpu_torch.data.loader import to_device
from msmctts_tpu_torch.models.quantizer import EMAQuantizer
from msmctts_tpu_torch.ops import vq
from msmctts_tpu_torch.parallel import mesh
from msmctts_tpu_torch.registry import get_trainer
from msmctts_tpu_torch.tasks import build_task
from msmctts_tpu_torch.training import losses as L


def _bounds(splits, rank):
    return splits[rank], splits[rank + 1]


def sharded_vq(group, device, x, embed, mask, splits):
    """Both sharded functions on rows [splits[rank], splits[rank + 1])."""
    lo, hi = _bounds(splits, group.rank)
    xl, ml, e = torch.as_tensor(x[lo:hi]), torch.as_tensor(mask[lo:hi]), torch.as_tensor(embed)
    mesh.reset_collective_counts()
    idx, quant, counts, sums = vq.vq_nearest_stats_sharded(xl, e, ml, group)
    stats_collectives = mesh.collective_counts()
    mesh.reset_collective_counts()
    s_idx, s_quant = vq.vq_nearest_sharded(xl, e)
    snap_collectives = mesh.collective_counts()
    return dict(idx=idx.numpy(), quant=quant.numpy(), counts=counts.numpy(), sums=sums.numpy(),
                snap_idx=s_idx.numpy(), snap_quant=s_quant.numpy(),
                stats_collectives=stats_collectives, snap_collectives=snap_collectives)


def quantizer_forward(group, device, x, lengths, embed, splits):
    """One training forward of ``EMAQuantizer`` on this rank's batch rows."""
    lo, hi = _bounds(splits, group.rank)
    H, d, K = embed.shape
    q = EMAQuantizer(H * d, K, n_head=H).train()
    with torch.no_grad():
        q.embed.copy_(torch.as_tensor(embed))
        q.embed_avg.copy_(torch.as_tensor(embed))
    q.group = group
    quant, diff, idx = q(torch.as_tensor(x[lo:hi]), lengths=torch.as_tensor(lengths[lo:hi]).long())
    return dict(quant=quant.numpy(), idx=idx.numpy(),
                codebook={k: getattr(q, k).numpy().copy() for k in ("embed", "cluster_size", "embed_avg")})


def loss_terms(data, group=None, lo=0, hi=None):
    """Every loss of ``training/losses.py`` on rows [lo, hi) of ``data``,
    with its gradient with respect to the rows' predictions."""
    sl = slice(lo, hi)
    t = {k: torch.as_tensor(v[sl]) for k, v in data.items()}
    lengths, text_lengths = t["lengths"].long(), t["text_lengths"].long()
    leaves = {k: t[k].clone().requires_grad_(True) for k in ("diff", "pred_mel", "dur_pred", "pred_wav", "fake_score", "fake_feat")}
    terms = {
        "masked_diff": L.masked_diff_loss(leaves["diff"], lengths, group),
        "frame": L.frame_loss(leaves["pred_mel"], t["mel"], lengths, group),
        "duration": L.duration_loss(leaves["dur_pred"], t["dur"], text_lengths, group),
        "mel": L.mel_loss(leaves["pred_wav"], t["wav"], 1600, fft_size=64, hop_size=16, win_size=64, num_mels=8, group=group),
        "lsgan_g": L.lsgan_g_loss([leaves["fake_score"]], group),
        "fm": L.feature_matching_loss([[leaves["fake_feat"]]], [[t["real_feat"]]], group),
    }
    d_real, d_fake = L.lsgan_d_loss([t["real_score"]], [leaves["fake_score"]], group)
    terms["lsgan_d"] = d_real + d_fake
    stft = L.multi_resolution_stft_loss(leaves["pred_wav"], t["wav"], fft_sizes=(64, 32), win_sizes=(48, 24),
                                        hop_sizes=(16, 8), group=group)
    terms["sc"], terms["mag"] = stft["sc_loss"], stft["mag_loss"]
    single = L.stft_loss(leaves["pred_wav"], t["wav"], fft_size=64, win_size=48, hop_size=16, mel_scale=True,
                         sample_rate=1600, num_mels=8, group=group)
    terms["sc_mel"] = single["sc_loss"]
    out = {}
    for name, value in terms.items():
        for leaf in leaves.values():
            leaf.grad = None
        value.backward(retain_graph=True)
        grads = {k: leaf.grad.numpy().copy() for k, leaf in leaves.items() if leaf.grad is not None}
        out[name] = (float(value.detach()), grads)
    return out


def loss_terms_rank(group, device, data, splits):
    lo, hi = _bounds(splits, group.rank)
    return loss_terms(data, group, lo, hi)


def build_trainer(config_dict, state, group=None):
    cfg = Config(config_dict)
    task = build_task(cfg, device="cpu", mode="train")
    trainer = get_trainer(cfg.trainer["_name"])(cfg, task, group=group, **component_kwargs(cfg.trainer))
    for name, sd in state.items():
        W.load_numpy_state(task.networks[name], sd)
    return trainer


def run_steps(trainer, batch, iterations, starts, group=None):
    """``trainer.train_step`` over ``iterations`` on this rank's rows of the
    global ``batch``; ``starts`` {iteration: [B] global window starts}."""
    rank, world = mesh.rank(group), mesh.world(group)
    local = to_device(mesh.shard_rows(batch, rank, world), "cpu")
    indices = []
    hooks = [q.register_forward_hook(lambda m, a, o: indices.append(o[2].numpy().copy()))
             for q in trainer.ae.quantizer.quantizer]
    metrics, collectives = [], []
    for it in iterations:
        s = None
        if starts and it in starts:
            s = torch.as_tensor(mesh.shard_rows({"s": np.asarray(starts[it])}, rank, world)["s"])
        mesh.reset_collective_counts()
        metrics.append({k: float(v) for k, v in trainer.train_step(local, it, starts=s).items()})
        collectives.append(mesh.collective_counts())
    for h in hooks:
        h.remove()
    deviation = mesh.max_deviation_from_rank0([trainer.ae, trainer.disc], group)
    W.assert_replicated([trainer.ae, trainer.disc], group)
    return dict(metrics=metrics, indices=indices, collectives=collectives, deviation=deviation,
                state={"autoencoder": W.state_dict_numpy(trainer.ae), "discriminator": W.state_dict_numpy(trainer.disc)},
                rng=trainer.generator.get_state().numpy().copy())


def run_restart_steps(trainer, batch, iterations, group=None):
    """``run_steps`` (no fixed windows), with the number of codewords each
    quantizer forward restarted: their count is exactly 1.0 after it."""
    restarted = []
    hooks = [q.register_forward_hook(lambda m, a, o: restarted.append(int((m.cluster_size == 1.0).sum())))
             for q in trainer.ae.quantizer.quantizer]
    out = run_steps(trainer, batch, iterations, None, group)
    for h in hooks:
        h.remove()
    out["restarted"] = restarted
    return out


def restart_steps_rank(group, device, config_dict, state, batch, iterations):
    torch.set_num_threads(2)
    return run_restart_steps(build_trainer(config_dict, state, group), batch, iterations, group)


def train_steps_rank(group, device, config_dict, state, batch, iterations, starts):
    torch.set_num_threads(2)
    return run_steps(build_trainer(config_dict, state, group), batch, iterations, starts, group)


def run_am_steps(trainer, batches, group=None):
    """A ``PredictorTrainer``'s steps over the global ``batches``, each on
    this rank's rows; the teacher's indices of every stage pass."""
    rank, world = mesh.rank(group), mesh.world(group)
    indices = []
    hooks = [q.register_forward_hook(lambda m, a, o: indices.append(o[2].numpy().copy()))
             for q in trainer.frozen_autoencoder().quantizer.quantizer]
    metrics, collectives = [], []
    for it, batch in enumerate(batches, 1):
        local = to_device(mesh.shard_rows(batch, rank, world), "cpu")
        mesh.reset_collective_counts()
        metrics.append({k: float(v) for k, v in trainer.train_step(local, it).items()})
        collectives.append(mesh.collective_counts())
    for h in hooks:
        h.remove()
    deviation = mesh.max_deviation_from_rank0([trainer.predictor], group)
    W.assert_replicated([trainer.predictor], group)
    return dict(metrics=metrics, indices=indices, collectives=collectives, deviation=deviation,
                state=W.state_dict_numpy(trainer.predictor), rng=trainer.generator.get_state().numpy().copy())


def am_steps_rank(group, device, config_dict, state, batches):
    torch.set_num_threads(2)
    return run_am_steps(build_trainer(config_dict, state, group), batches, group)


def _network_state(trainer):
    return {n: W.state_dict_numpy(m) for n, m in trainer.task.networks.items()}


def run_emb_steps(trainer, batch, steps, group=None, starts=None):
    """An ``EmbVQGANTrainer``'s iterations 1..``steps`` on this rank's rows
    of the global ``batch``, windows drawn by the trainer. With ``starts``
    (a list of network states), iteration i begins from ``starts[i - 1]``.
    Returns the state each iteration began from, and per decoding iteration
    the number of real (weight 1) windows this rank decoded."""
    rank, world = mesh.rank(group), mesh.world(group)
    local = to_device(mesh.shard_rows(batch, rank, world), "cpu")
    windows, current = {}, [0]
    draw = trainer.local_windows

    def recording(*args, **kwargs):
        out = draw(*args, **kwargs)
        windows[current[0]] = int(out[2].sum())
        return out

    trainer.local_windows = recording
    metrics, began = [], []
    for it in range(1, steps + 1):
        current[0] = it
        if starts is not None:
            for name, sd in starts[it - 1].items():
                W.load_numpy_state(trainer.task.networks[name], sd)
        began.append(_network_state(trainer))
        metrics.append({k: float(v) for k, v in trainer.train_step(local, it).items()})
    modules = list(trainer.task.networks.values())
    deviation = mesh.max_deviation_from_rank0(modules, group)
    W.assert_replicated(modules, group)
    return dict(metrics=metrics, windows=windows, deviation=deviation, began=began, state=_network_state(trainer),
                rng=trainer.generator.get_state().numpy().copy())


def emb_steps_rank(group, device, config_dict, state, batch, steps, starts):
    torch.set_num_threads(2)
    return run_emb_steps(build_trainer(config_dict, state, group), batch, steps, group, starts)


def build_inference_task(am_checkpoint):
    from msmctts_tpu_torch.utils.checkpoint import load_checkpoint

    ck = load_checkpoint(am_checkpoint)
    task = build_task(Config(ck["config"]), device="cpu")
    task.load_variables(ck["state"])
    task.pre_infer()
    return task


def infer_rank(group, device, am_checkpoint, text_batch, mel_batch):
    """``predict`` and ``analysis_synthesis`` on global batches through
    ``use_mesh``; every rank returns the whole batch's outputs."""
    task = build_inference_task(am_checkpoint).use_mesh(group)
    mesh.reset_collective_counts()
    out = task.predict(text_batch)
    collectives = mesh.collective_counts()
    return dict(predict=out, analysis_synthesis=task.analysis_synthesis(mel_batch), collectives=collectives)
