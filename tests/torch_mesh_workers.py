"""What each rank runs in ``tests/test_torch_mesh_inference.py`` and
``tests/test_torch_tensor_parallel.py``: fresh processes
(``msmctts_tpu_torch.parallel.launch.run_ranks``) that import this module
to find their function, so it imports torch and the port only; inputs and
results cross the process boundary as numpy arrays."""

import numpy as np
import torch

from msmctts_tpu_torch.ops.int8_generator import Int8Decoder
from msmctts_tpu_torch.parallel import mesh, sharding
from msmctts_tpu_torch.serving import BatchingEngine
from msmctts_tpu_torch.utils.checkpoint import load_checkpoint
from tests.torch_parallel_workers import build_inference_task

SR = 1600


def _scaled(tree, factor):
    if isinstance(tree, dict):
        return {k: _scaled(v, factor) for k, v in tree.items()}
    return np.asarray(tree) * np.float32(factor)


def engine_kwargs(**kw):
    """The engine both packages' mesh tests serve with: batch 4 at text
    length 8 (the JAX engine's first text bucket for these texts), cap 64."""
    return dict(dict(sample_rate=SR, batch_size=4, window_ms=0.0, text_length=8, max_frames=64,
                     stream_chunk_frames=8), **kw)


def int8_rank(group, device, am_path, batch):
    """``predict`` with the int8 decoder over the group, its scales, and
    what a calibration on this rank's rows alone would give."""
    torch.set_num_threads(2)
    task = build_inference_task(am_path).use_mesh(group)
    task.int8_decoder = True
    out = task.infer_step(batch)
    scales = dict(task._int8_state.scales)
    _, _, feats = task.predict_features(batch)
    ae = task.networks["autoencoder"]
    alone = Int8Decoder(ae.decoder, ae.decoder_config, dtype=task.compute_dtype)
    alone.calibrate(feats)  # this rank's rows only
    with torch.inference_mode():
        alone_wav = task._gather(alone.apply(feats)[..., 0].float())
    return dict(wav=out["wav"], scales=scales, alone_scales=dict(alone.scales), alone_wav=alone_wav)


def engine_rank(group, device, am_path, texts, zero_margin):
    """An engine over the group: warmup, the texts one by one, a stream of
    the first, ``reload`` to doubled weights and back; rank 0 returns what
    it served, the followers their own counters."""
    torch.set_num_threads(2)
    task = build_inference_task(am_path)
    eng = BatchingEngine(task, **engine_kwargs(group=group))
    if zero_margin:  # the JAX package's frame bucket (no margin), to compare with its engine
        task.frame_margin = 0
    if group.rank != 0:
        eng.follow()
        return dict(cold_shapes=eng._own_cold_shapes(), kernel_builds=eng._own_kernel_builds(),
                    shapes=sorted(task.shapes, key=str))
    mesh.reset_collective_counts()
    eng.start(warmup={"text_lengths": None, "include_streaming": None})
    warm = mesh.collective_counts(by_group=True)
    try:
        solo = [eng.synthesize(t, timeout=120) for t in texts]
        stream = list(eng.synthesize_stream(texts[0], timeout=120))
        stats = eng.snapshot()
        state = load_checkpoint(am_path)["state"]
        bumped = dict(state, params=_scaled(state["params"], 2.0))
        eng.reload(bumped)
        w_new = eng.synthesize(texts[0], timeout=120)
        eng.reload(state)
        w_back = eng.synthesize(texts[0], timeout=120)
    finally:
        eng.stop()
    return dict(solo=solo, stream=stream, stats=stats, w_new=w_new, w_back=w_back, warm_collectives=warm,
                shapes=sorted(task.shapes, key=str), streaming_warm=eng._streaming_warm)


def failing_follower_rank(group, device, am_path, text):
    """A follower whose task raises on its first served batch: rank 0's
    request fails within the group's timeout, the next one at once, and
    ``stop`` still ends the follower."""
    import time

    torch.set_num_threads(2)
    task = build_inference_task(am_path)
    eng = BatchingEngine(task, **engine_kwargs(group=group))
    if group.rank != 0:
        def boom(batch):
            raise RuntimeError("follower failed on purpose")

        task.infer_step = boom
        eng.follow()
        return None
    eng.start()
    out = {}
    try:
        for name in ("first", "second"):
            t0 = time.time()
            try:
                eng.synthesize(text, timeout=120)
                out[name] = ("ok", time.time() - t0)
            except Exception as e:
                out[name] = (f"{type(e).__name__}: {e}", time.time() - t0)
        out["stats"] = eng.snapshot()
    finally:
        eng.stop()
    return out


# ---------------------------------------------------------- tensor parallelism


def _rows(trainer, batch):
    """This rank's rows of a global numpy batch: its block of the data axis."""
    from msmctts_tpu_torch.data.loader import to_device

    return to_device(mesh.shard_rows(batch, trainer.rank, trainer.world), "cpu")


def _whole(trainer, modules):
    """The gathered state of ``modules`` and its deviation across the whole
    run (0.0: bit-equal on every rank)."""
    from msmctts_tpu_torch import weights as W

    trainer.unshard()
    deviation = mesh.max_deviation_from_rank0(modules, trainer.world_group)
    return [W.state_dict_numpy(m) for m in modules], deviation


def _plan_facts(trainer):
    plan = trainer._plan
    split = {}
    for module in trainer._trainable():
        for name, p in module.named_parameters():
            if getattr(p, "tp_dim", None) is not None:
                split[name] = (p.tp_dim, tuple(p.shape))
    kinds = {}
    for layer in plan.modules:  # paired blocks: an MRF block holds one pair a dilation
        kinds[type(layer).__name__] = kinds.get(type(layer).__name__, 0) + len(getattr(layer, "dilations", (1,)))
    return dict(marked=dict(plan.marked), replicated=dict(plan.replicated), split=split, blocks=kinds)


def tp_ae_rank(group, device, config_dict, state, batch, iterations, starts):
    """``VQGANTrainer`` steps over a data x model group (the config's
    ``mesh``) on this rank's rows; the gathered state, metrics, collectives
    by group per step, and what was split."""
    from tests.torch_parallel_workers import build_trainer

    torch.set_num_threads(1)
    trainer = build_trainer(config_dict, state, group)
    local = _rows(trainer, batch)
    metrics, collectives = [], []
    for it in iterations:
        s = None
        if starts and it in starts:
            s = torch.as_tensor(mesh.shard_rows({"s": np.asarray(starts[it])}, trainer.rank, trainer.world)["s"])
        mesh.reset_collective_counts()
        sharding.PAIR_REDUCES[0] = 0
        metrics.append({k: float(v) for k, v in trainer.train_step(local, it, starts=s).items()})
        collectives.append(dict(mesh.collective_counts(by_group=True), pair_reduces=sharding.PAIR_REDUCES[0]))
    facts = _plan_facts(trainer)
    (ae, disc), deviation = _whole(trainer, [trainer.ae, trainer.disc])
    out = dict(metrics=metrics, collectives=collectives, deviation=deviation, facts=facts,
               rng=trainer.generator.get_state().numpy().copy(), ranks=(trainer.rank, trainer.world, trainer.tp.rank))
    if group.rank == 0:
        out["state"] = {"autoencoder": ae, "discriminator": disc}
    return out


def tp_resume_rank(group, device, config_dict, state, batch, starts, save_dir):
    """Steps 1-2, a checkpoint, steps 3-4; then a fresh trainer resumed
    from the checkpoint runs steps 3-4 again."""
    from tests.torch_parallel_workers import build_trainer

    torch.set_num_threads(1)
    out = {}
    for name in ("continued", "resumed"):
        trainer = build_trainer(config_dict, state, group)
        trainer.save_dir = save_dir
        local = _rows(trainer, batch)
        if name == "resumed":
            trainer.load(out["path"])
        metrics = []
        for it in (1, 2, 3, 4) if name == "continued" else (3, 4):
            s = None
            if it in starts:
                s = torch.as_tensor(mesh.shard_rows({"s": np.asarray(starts[it])}, trainer.rank, trainer.world)["s"])
            metrics.append({k: float(v) for k, v in trainer.train_step(local, it, starts=s).items()})
            if name == "continued" and it == 2:
                trainer.iteration = 2
                out["path"] = mesh.broadcast_object(trainer.save(), group)
                out["saved_state"] = _whole(trainer, [trainer.ae, trainer.disc])[0]
                trainer.shard()
        (ae, disc), _ = _whole(trainer, [trainer.ae, trainer.disc])
        out[name] = dict(metrics=metrics, state={"autoencoder": ae, "discriminator": disc} if group.rank == 0 else None)
    return out


def tp_am_rank(group, device, config_dict, state, batches):
    """``PredictorTrainer`` steps over a data x model group."""
    from tests.torch_parallel_workers import build_trainer

    torch.set_num_threads(1)
    trainer = build_trainer(config_dict, state, group)
    metrics = []
    for it, batch in enumerate(batches, 1):
        mesh.reset_collective_counts()
        metrics.append({k: float(v) for k, v in trainer.train_step(_rows(trainer, batch), it).items()})
    facts = _plan_facts(trainer)
    (pred,), deviation = _whole(trainer, [trainer.predictor])
    return dict(metrics=metrics, deviation=deviation, facts=facts, state=pred if group.rank == 0 else None)


def tp_emb_rank(group, device, config_dict, state, batch, steps):
    """``EmbVQGANTrainer`` steps over a data x model group, windows drawn
    by the trainer from the global batch."""
    from msmctts_tpu_torch import weights as W
    from tests.torch_parallel_workers import build_trainer

    torch.set_num_threads(1)
    trainer = build_trainer(config_dict, state, group)
    local = _rows(trainer, batch)
    metrics = [{k: float(v) for k, v in trainer.train_step(local, it).items()} for it in range(1, steps + 1)]
    facts = _plan_facts(trainer)
    modules = list(trainer.task.networks.values())
    _, deviation = _whole(trainer, modules)
    state = {n: W.state_dict_numpy(m) for n, m in trainer.task.networks.items()} if group.rank == 0 else None
    return dict(metrics=metrics, deviation=deviation, facts=facts, state=state)
