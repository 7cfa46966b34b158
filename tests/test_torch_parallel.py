"""Data-parallel execution of the port (``msmctts_tpu_torch/parallel``) on
the CPU: W real processes over gloo against one process, and against the
JAX package on its 8-device CPU mesh.

What must hold: W ranks on a global batch compute what one rank computes on
it. Codeword indices, codewords and counts are exact (counts are small
integers in fp32); sums over rows differ by the rounding of another order
of addition; everything replicated (parameters, codebooks, statistics) is
bit-equal across the ranks of one run.

Tolerances (fp32, JAX under matmul precision "highest").
  * sharded statistics: sums rtol 1e-5 + atol 2e-4 against the JAX
    package's sharded op (Pallas kernel in interpret mode, ``psum`` over 8
    devices) and against one rank (observed: up to 7.6e-6);
  * ``EMAQuantizer``'s codebook after one sharded training forward: rtol
    1e-6 + atol 1e-6 against JAX, whose own 8-against-1 test allows rtol
    1e-5 (observed: 2.2e-7 relative, on codewords of size up to 34: the
    first update divides by cluster sizes near 0.01);
  * loss terms summed over ranks against one rank, and their gradients:
    1e-6 (observed: exact but for the spectral convergence, 7.3e-7
    relative);
  * 2 warmup + 2 GAN steps, 2 ranks against 1 with dropout on: metrics rtol
    2e-4 / atol 1e-5, codebook rtol 2e-4 / atol 1e-5, parameters rtol 2e-3 /
    atol 2e-4, the tolerances the JAX package holds 8 devices to against 1
    (``tests/test_parallel.py``) (observed: metrics 1.9e-7 relative,
    codebook and parameters 6.9e-6 absolute);
  * the same steps, dropout 0 and given window starts, 2 ranks against the
    JAX trainer on its 8-device mesh: the tolerances of
    ``tests/test_torch_train_slice.py`` (metrics 2e-5 relative, codebook
    2e-5, parameters ``2 * lr * steps`` with at most 0.2 % of the entries
    further than 1e-5 apart; observed: parameters up to 4.8e-5 apart).
"""

import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.sharding import NamedSharding, PartitionSpec as P

from msmctts_tpu.config import component_kwargs
from msmctts_tpu.data.loader import DataLoader as JDataLoader
from msmctts_tpu.models.quantizer import EMAQuantizer as JEMAQuantizer
from msmctts_tpu.ops.pallas_vq import vq_nearest_stats_sharded as j_vq_nearest_stats_sharded
from msmctts_tpu.parallel.mesh import make_mesh, pad_batch_to_devices as j_pad_batch_to_devices, shard_batch
from msmctts_tpu.parallel.sharding import shard_state
from msmctts_tpu.registry import get_trainer
from msmctts_tpu.tasks import build_task
from msmctts_tpu.training.base_trainer import build_dataset_from_config as j_build_dataset
from msmctts_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from msmctts_tpu_torch import weights as W
from msmctts_tpu_torch.ops import vq
from msmctts_tpu_torch.parallel import mesh
from msmctts_tpu_torch.parallel.launch import run_ranks
from msmctts_tpu_torch.utils.checkpoint import find_latest_checkpoint, load_checkpoint
from tests import torch_parallel_workers as workers
from tests.tiny import tiny_ae_config, tiny_am_config, write_tiny_dataset

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUMS_TOL = dict(rtol=1e-5, atol=2e-4)
LR = 2e-4
STEPS = [1, 2, 3, 4]  # 2 warmup + 2 GAN


def _ranks(fn, world, *args, timeout_s=120.0):
    return run_ranks(fn, world, "gloo", ["cpu"] * world, *args, timeout_s=timeout_s, threads=2)


def _even_splits(n, world):
    return [n * r // world for r in range(world + 1)]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _no_dropout(config):
    ae = config["task"]["autoencoder"]
    for node in (ae["encoder_config"], ae["frame_decoder_config"]):
        node["dropout"] = 0.0
        node["attn_dropout"] = 0.0
    ae["quantizer_config"]["dropout"] = 0.0
    ae["quantizer_config"]["prior_config"]["p_dropout"] = 0.0
    return config


# ------------------------------------------------------------- the kernels' functions


@pytest.mark.parametrize("world,N,masked_rank", [(2, 512, None), (4, 512, 1), (2, 509, 0), (4, 509, None)],
                         ids=["w2-n512", "w4-n512-rank1-masked", "w2-n509-rank0-masked", "w4-n509"])
def test_sharded_stats_match_jax_sharded_op_and_one_rank(world, N, masked_rank):
    rng = np.random.default_rng(N + world)
    H, d, K = 2, 8, 16
    x = rng.normal(size=(N, H, d)).astype(np.float32)
    embed = rng.normal(size=(H, d, K)).astype(np.float32)
    mask = (rng.random(N) > 0.2).astype(np.float32)
    splits = _even_splits(N, world)  # ragged when world does not divide N
    if masked_rank is not None:
        mask[splits[masked_rank] : splits[masked_rank + 1]] = 0.0
    res = _ranks(workers.sharded_vq, world, x, embed, mask, splits)

    # the JAX package's sharded op over its 8-device mesh (rows padded with
    # masked rows up to a multiple of 8: they add nothing to the statistics)
    Np = -(-N // 8) * 8
    xp = np.concatenate([x, np.zeros((Np - N, H, d), np.float32)])
    mp_ = np.concatenate([mask, np.zeros(Np - N, np.float32)])
    jmesh = make_mesh(8)
    j_idx, j_quant, j_counts, j_sums = jax.jit(j_vq_nearest_stats_sharded)(
        jax.device_put(xp, NamedSharding(jmesh, P("data"))), jax.device_put(embed, NamedSharding(jmesh, P())),
        jax.device_put(mp_, NamedSharding(jmesh, P("data"))),
    )
    one = vq.vq_nearest_stats(torch.as_tensor(x), torch.as_tensor(embed), torch.as_tensor(mask))

    idx = np.concatenate([r["idx"] for r in res])
    quant = np.concatenate([r["quant"] for r in res])
    np.testing.assert_array_equal(idx, np.asarray(j_idx)[:N])
    np.testing.assert_array_equal(quant, np.asarray(j_quant)[:N])
    np.testing.assert_array_equal(idx, one[0].numpy())
    np.testing.assert_array_equal(quant, one[1].numpy())
    for r in res:  # global, and bit-equal on every rank
        np.testing.assert_array_equal(r["counts"], res[0]["counts"])
        np.testing.assert_array_equal(r["sums"], res[0]["sums"])
        assert r["stats_collectives"]["all_reduce"] == {"calls": 1, "bytes": (H * K + H * d * K) * 4}
    np.testing.assert_array_equal(res[0]["counts"], np.asarray(j_counts))
    np.testing.assert_array_equal(res[0]["counts"], one[2].numpy())
    assert res[0]["counts"].sum() == mask.sum() * H
    np.testing.assert_allclose(res[0]["sums"], np.asarray(j_sums), **SUMS_TOL)
    np.testing.assert_allclose(res[0]["sums"], one[3].numpy(), **SUMS_TOL)

    # the snap: this rank's rows of the one-rank snap, bit for bit, no collective
    s_idx, s_quant = vq.vq_nearest(torch.as_tensor(x), torch.as_tensor(embed))
    np.testing.assert_array_equal(np.concatenate([r["snap_idx"] for r in res]), s_idx.numpy())
    np.testing.assert_array_equal(np.concatenate([r["snap_quant"] for r in res]), s_quant.numpy())
    for r in res:
        assert all(v["calls"] == 0 for v in r["snap_collectives"].values())


def test_sharded_functions_without_a_group_are_the_one_rank_functions():
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(70, 2, 4)).astype(np.float32))
    e = torch.as_tensor(rng.normal(size=(2, 4, 6)).astype(np.float32))
    m = torch.as_tensor((rng.random(70) > 0.3).astype(np.float32))
    mesh.reset_collective_counts()
    for got, want in zip(vq.vq_nearest_stats_sharded(x, e, m), vq.vq_nearest_stats(x, e, m)):
        assert torch.equal(got, want)
    for got, want in zip(vq.vq_nearest_stats_sharded(x, e, m, None), vq.vq_nearest_stats_sharded_plain(x, e, m, None)):
        assert torch.equal(got, want)
    for got, want in zip(vq.vq_nearest_sharded(x, e), vq.vq_nearest(x, e)):
        assert torch.equal(got, want)
    # a rank without rows contributes zeros
    _, _, counts, sums = vq.vq_nearest_stats_sharded(x[:0], e, m[:0])
    assert counts.shape == (2, 6) and sums.shape == (2, 4, 6) and float(counts.sum()) == 0.0 == float(sums.abs().sum())
    assert all(v["calls"] == 0 for v in mesh.collective_counts().values())
    assert vq.KERNEL.launches == 0 == vq.STATS_KERNEL.launches  # no launch on the CPU
    with pytest.raises(ValueError, match="unsupported device"):
        vq.vq_nearest_stats_sharded(x.to("meta"), e.to("meta"), m.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        vq.vq_nearest_sharded(x.to("meta"), e.to("meta"))


def test_ema_quantizer_sharded_batch_matches_jax():
    """The JAX side of ``test_pallas_vq.py::test_emaquantizer_pallas_sharded_batch``
    against the port's quantizer on 2 ranks."""
    rng = np.random.default_rng(0)
    D, K, H, B, T = 8, 10, 2, 8, 24
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    lengths = rng.integers(8, T + 1, size=(B,)).astype(np.int32)
    embed = rng.normal(size=(H, D // H, K)).astype(np.float32)
    codebook = {"embed": jnp.asarray(embed), "cluster_size": jnp.zeros((H, K), jnp.float32), "embed_avg": jnp.asarray(embed)}
    q = JEMAQuantizer(embed_dim=D, n_embed=K, n_head=H, use_pallas=True)
    jmesh = make_mesh(8)
    with jax.default_matmul_precision("highest"):
        (qt, _, idx), mut = jax.jit(lambda cb, xx, ll: q.apply({"codebook": cb}, xx, lengths=ll, mutable=["codebook"]))(
            jax.device_put(codebook, NamedSharding(jmesh, P())), jax.device_put(x, NamedSharding(jmesh, P("data"))),
            jax.device_put(lengths, NamedSharding(jmesh, P("data"))),
        )
    res = _ranks(workers.quantizer_forward, 2, x, lengths, embed, _even_splits(B, 2))
    np.testing.assert_array_equal(np.concatenate([r["idx"] for r in res]), np.asarray(idx))
    np.testing.assert_allclose(np.concatenate([r["quant"] for r in res]), np.asarray(qt), rtol=1e-6, atol=1e-6)
    for name in ("embed", "cluster_size", "embed_avg"):
        np.testing.assert_array_equal(res[0]["codebook"][name], res[1]["codebook"][name])
        np.testing.assert_allclose(res[0]["codebook"][name], np.asarray(mut["codebook"][name]), rtol=1e-6, atol=1e-6, err_msg=name)
    assert not np.allclose(res[0]["codebook"]["embed"], embed)


# ------------------------------------------------------------------------- the losses


@pytest.fixture(scope="module")
def loss_data():
    rng = np.random.default_rng(11)
    B, T, D, Lt, S = 6, 20, 8, 9, 160
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return dict(
        lengths=np.array([20, 13, 7, 18, 3, 11], np.int64), text_lengths=np.array([9, 4, 7, 2, 8, 5], np.int64),
        diff=np.abs(f(B, T, D)), pred_mel=f(B, T, D), mel=f(B, T, D), dur_pred=f(B, Lt), dur=np.abs(f(B, Lt)),
        pred_wav=f(B, S) * 0.3, wav=f(B, S) * 0.3, fake_score=f(B, 7), real_score=f(B, 7),
        fake_feat=f(B, 4, 5), real_feat=f(B, 4, 5),
    )


@pytest.fixture(scope="module")
def loss_runs(loss_data):
    return workers.loss_terms(loss_data), _ranks(workers.loss_terms_rank, 2, loss_data, [0, 3, 6])


@pytest.mark.parametrize("term", ["masked_diff", "frame", "duration", "mel", "lsgan_g", "lsgan_d", "fm", "sc", "mag", "sc_mel"])
def test_loss_shares_sum_to_the_one_rank_term(loss_runs, term):
    one, ranks = loss_runs
    want, want_grads = one[term]
    got = sum(r[term][0] for r in ranks)
    assert got == pytest.approx(want, rel=1e-6, abs=1e-6)
    assert want_grads
    for k, g in want_grads.items():
        np.testing.assert_allclose(np.concatenate([r[term][1][k] for r in ranks]), g, rtol=1e-5, atol=1e-6, err_msg=k)


# ----------------------------------------------------------------- mesh's host helpers


def test_pad_and_shard_rows_follow_the_jax_package():
    rng = np.random.default_rng(2)
    batch = {"mel": rng.normal(size=(6, 5, 3)).astype(np.float32), "mel_length": np.arange(6), "scalar": np.float32(3.0)}
    for n in (2, 4, 8):
        got, want = mesh.pad_batch_to_devices(batch, n), j_pad_batch_to_devices(batch, n)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        assert got["mel"].shape[0] % n == 0
    padded = mesh.pad_batch_to_devices(batch, 4)
    blocks = [mesh.shard_rows(padded, r, 4) for r in range(4)]
    np.testing.assert_array_equal(np.concatenate([b["mel"] for b in blocks]), padded["mel"])
    assert all(b["scalar"] == np.float32(3.0) for b in blocks)
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard_rows(batch, 0, 4)
    assert mesh.world(None) == 1 and mesh.rank(None) == 0
    t = torch.ones(3)
    assert mesh.all_reduce_sum(t, None) is t and mesh.broadcast(t, None) is t and mesh.all_gather_rows(t, None) is t
    assert mesh.agree_any(True, None) and not mesh.agree_any(False, None)
    with pytest.raises(ValueError, match="not one of"):
        mesh.init_distributed("mpi", 0, 1, "tcp://127.0.0.1:1")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        mesh.init_distributed("nccl", 0, 1, "tcp://127.0.0.1:1", "cpu")


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank 1"):  # rank 1 finds no rows to take
        _ranks(workers.sharded_vq, 2, np.zeros((4, 1, 2), np.float32), np.zeros((1, 2, 3), np.float32),
               np.ones(4, np.float32), [0, 2], timeout_s=60)


# ---------------------------------------------------------------- the slice as a whole


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_parallel_corpus"))
    write_tiny_dataset(d, n_utts=8)
    return d


def _global_batch(config):
    batch = next(iter(JDataLoader(j_build_dataset(config, training=True), batch_size=8, num_workers=0)))
    return {k: batch[k] for k in ("mel", "mel_length", "wav")}


@pytest.fixture(scope="module")
def dropout_runs(corpus):
    """2 warmup + 2 GAN steps at global batch 8 with the recipe's dropout
    on, from one seeded state: one rank, and two ranks over gloo."""
    config = tiny_ae_config(corpus)
    batch = _global_batch(config)
    trainer = workers.build_trainer(config.to_dict(), {})
    trainer.init_state()
    state = {"autoencoder": W.state_dict_numpy(trainer.ae), "discriminator": W.state_dict_numpy(trainer.disc)}
    one = workers.run_steps(trainer, batch, STEPS, None)
    two = _ranks(workers.train_steps_rank, 2, config.to_dict(), state, batch, STEPS, None, timeout_s=240)
    return one, two, state


def _codebook_keys(sd):
    return [k for k in sd if k.split(".")[-1] in ("embed", "cluster_size", "embed_avg")]


def test_two_ranks_with_dropout_match_one_rank_metrics(dropout_runs):
    one, two, _ = dropout_runs
    for it, (m1, m2) in enumerate(zip(one["metrics"], two[0]["metrics"]), 1):
        assert sorted(m1) == sorted(m2)
        assert ("d_loss" in m1) == (it > 2)
        for k in m1:
            np.testing.assert_allclose(m2[k], m1[k], rtol=2e-4, atol=1e-5, err_msg=f"step {it} {k}")
    assert two[0]["metrics"] == two[1]["metrics"]  # the global values, on every rank
    # the first step's assignments: the ranks' rows are the one rank's rows
    for stage in range(2):
        np.testing.assert_array_equal(
            np.concatenate([two[0]["indices"][stage], two[1]["indices"][stage]]), one["indices"][stage])


def test_two_ranks_with_dropout_match_one_rank_state(dropout_runs):
    one, two, state0 = dropout_runs
    sd1, sd2 = one["state"]["autoencoder"], two[0]["state"]["autoencoder"]
    keys = _codebook_keys(sd1)
    assert len(keys) == 6
    for k in keys:
        np.testing.assert_allclose(sd2[k], sd1[k], rtol=2e-4, atol=1e-5, err_msg=k)
    moved = 0
    for module in ("autoencoder", "discriminator"):
        for k, v in one["state"][module].items():
            np.testing.assert_allclose(two[0]["state"][module][k], v, rtol=2e-3, atol=2e-4, err_msg=k)
            moved += int(not np.array_equal(v, state0[module][k]))
    assert moved > 100  # the steps did move both networks
    # one generator state for the whole run: every rank drew what one rank draws
    np.testing.assert_array_equal(two[0]["rng"], one["rng"])
    np.testing.assert_array_equal(two[1]["rng"], one["rng"])


def test_state_is_bit_equal_across_ranks_and_collectives_are_counted(dropout_runs):
    _, two, _ = dropout_runs
    assert two[0]["deviation"] == 0.0 and two[1]["deviation"] == 0.0
    for module in ("autoencoder", "discriminator"):
        for k, v in two[0]["state"][module].items():
            np.testing.assert_array_equal(two[1]["state"][module][k], v, err_msg=k)
    # per step: 2 quantizer stages + 4 masked denominators + 1 metrics vector
    # + 1 per optimizer that steps (the discriminator's in the GAN phase only)
    calls = [c["all_reduce"]["calls"] for c in two[0]["collectives"]]
    assert calls == [8, 8, 9, 9]
    assert all(c["broadcast"]["calls"] == 0 and c["all_gather"]["calls"] == 0 for c in two[0]["collectives"])


@pytest.fixture(scope="module")
def jax_runs(corpus):
    """The same four steps, dropout 0 and the window starts JAX draws: the
    JAX trainer on its 8-device mesh, and the port on two ranks from the
    JAX trainer's initial state."""
    config = _no_dropout(tiny_ae_config(corpus))
    config["save_checkpoint_dir"] = corpus + "/ckpt_jax_runs"
    batch = _global_batch(config)
    jmesh = make_mesh(8)
    with jax.default_matmul_precision("highest"):
        jtask = build_task(config, mode="train")
        jtrainer = get_trainer("VQGANTrainer")(config, jtask, mesh=jmesh, **component_kwargs(config.trainer))
        state0 = jax.device_get(jtrainer.init_state(jax.random.PRNGKey(0), batch))
        state, sharded = shard_state(state0, jmesh), shard_batch(batch, jmesh)
        j_metrics, starts = [], {}
        for it in STEPS:
            state, m = jtrainer.train_step(state, sharded, it)
            j_metrics.append(m.to_host())
            if it > jtrainer.warmup_steps:
                r_win, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(jtrainer.seed), np.uint32(it)))
                maxval = np.maximum(batch["mel_length"].astype(np.int32) - jtrainer.frame_lengths, 1)
                starts[it] = np.asarray(jax.random.randint(r_win, (8,), 0, maxval))
        final = jax.device_get(state)
    trainer = workers.build_trainer(config.to_dict(), {})
    W.train_state_from_jax(state0, trainer.ae, trainer.disc)
    state_t = {"autoencoder": W.state_dict_numpy(trainer.ae), "discriminator": W.state_dict_numpy(trainer.disc)}
    two = _ranks(workers.train_steps_rank, 2, config.to_dict(), state_t, batch, STEPS, starts, timeout_s=240)
    W.load_numpy_state(trainer.ae, two[0]["state"]["autoencoder"])
    W.load_numpy_state(trainer.disc, two[0]["state"]["discriminator"])
    return dict(j_metrics=j_metrics, state0=state0, final=final, two=two,
                got=W.train_state_to_jax(trainer.ae, trainer.disc))


def test_two_ranks_match_the_jax_trainer_on_its_mesh_metrics(jax_runs):
    for it, (want, got) in enumerate(zip(jax_runs["j_metrics"], jax_runs["two"][0]["metrics"]), 1):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=2e-5, abs=1e-6), (it, k, got[k], want[k])


def test_two_ranks_match_the_jax_trainer_on_its_mesh_state(jax_runs):
    got, final = jax_runs["got"], jax_runs["final"]
    for stage, node in final["codebook"]["quantizer"].items():
        for key in ("embed", "cluster_size", "embed_avg"):
            np.testing.assert_allclose(got["codebook"]["quantizer"][stage][key], node[key], rtol=2e-5, atol=2e-5,
                                       err_msg=f"{stage}.{key}")
    for module, steps in (("autoencoder", 4), ("discriminator", 2)):
        a, b = _flat(got["params"][module]), _flat(final["params"][module])
        start = _flat(jax_runs["state0"]["params"][module])
        assert sorted(a) == sorted(b)
        far = total = moved = 0
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=2 * LR * steps + 1e-6, err_msg=k)
            far += int((np.abs(a[k] - b[k]) > 1e-5).sum())
            total += b[k].size
            moved += int((b[k] != start[k]).sum())
        assert far <= 0.002 * total, (module, far, total)
        assert moved > 0.5 * total


# ------------------------------------------------------------------- the entry points


def _write_config(corpus, save_dir, **overrides):
    config = tiny_ae_config(corpus).to_dict()
    config["save_checkpoint_dir"] = save_dir
    config["dataloader"]["batch_size"] = 8  # the global batch
    config.update(overrides)
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def _run_cli(module, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_train_dist_two_processes_match_one_process(corpus, tmp_path):
    """The launcher on the CPU: 2 ranks x 4 rows against 1 process x 8 rows
    of the same global batches, 4 steps with dropout on."""
    mh, sp = str(tmp_path / "mh"), str(tmp_path / "sp")
    res = _run_cli("msmctts_tpu_torch.train_dist", "-c", _write_config(corpus, mh), "--nproc", "2", "--device", "cpu",
                   "--max-steps", "4", "--log-every", "2")
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "rank 1 of 2 on cpu, backend gloo" in res.stdout
    res = _run_cli("msmctts_tpu_torch.train", "-c", _write_config(corpus, sp), "--device", "cpu", "--max-steps", "4",
                   "--log-every", "2")
    assert res.returncode == 0, res.stderr[-3000:]

    # one checkpoint, written by rank 0; a log per rank, with equal (global) metrics
    files = sorted(os.listdir(mh))
    assert [f for f in files if f.startswith("model_")] == ["model_4"]
    logs = {r: [f for f in files if f.startswith(f"train_rank{r}_")] for r in (0, 1)}
    assert len(logs[0]) == 1 and len(logs[1]) == 1
    lines = {r: [l.split("] ", 1)[1].split(" steps_per_sec")[0] for l in open(os.path.join(mh, logs[r][0])) if "step 4" in l]
             for r in (0, 1)}
    assert lines[0] and lines[0] == lines[1]

    a, b = load_checkpoint(os.path.join(mh, "model_4")), load_checkpoint(os.path.join(sp, "model_4"))
    assert a["iteration"] == b["iteration"] == 4
    for stage, node in b["state"]["codebook"]["quantizer"].items():
        for key in ("embed", "cluster_size", "embed_avg"):
            np.testing.assert_allclose(a["state"]["codebook"]["quantizer"][stage][key], node[key], rtol=2e-4, atol=1e-5,
                                       err_msg=f"{stage}.{key}")
    fa, fb = _flat(a["state"]["params"]), _flat(b["state"]["params"])
    assert sorted(fa) == sorted(fb)
    for k in fb:
        np.testing.assert_allclose(fa[k], fb[k], rtol=2e-3, atol=2e-4, err_msg=k)
    np.testing.assert_array_equal(a["state"]["torch_rng"], b["state"]["torch_rng"])

    # the JAX package loads what the two ranks trained
    from msmctts_tpu.config import Config

    jck = j_load_checkpoint(os.path.join(mh, "model_4"))
    assert jck["iteration"] == 4 and "discriminator" in jck["state"]["params"]
    rng = np.random.default_rng(3)
    batch = {"mel": rng.normal(size=(2, 16, 8)).astype(np.float32), "mel_length": np.array([16, 9], np.int32)}
    with jax.default_matmul_precision("highest"):
        jtask = build_task(Config(jck["config"]), mode="infer")
        jtask.load_variables(jck["state"])
        wav = jtask.analysis_synthesis(batch)["wav"]
    assert [np.asarray(w).shape for w in wav] == [(64,), (36,)] and all(np.isfinite(np.asarray(w)).all() for w in wav)


def test_sigterm_to_one_rank_stops_both_with_one_resumable_checkpoint(corpus, tmp_path):
    from msmctts_tpu_torch.train_dist import _free_port

    save = str(tmp_path / "pre")
    cfg = _write_config(corpus, save, training_steps=100000, iters_per_checkpoint=100000)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "msmctts_tpu_torch.train", "-c", cfg, "--device", "cpu", "--log-every", "1",
             "--coordinator", coordinator, "--num-processes", "2", "--process-id", str(r)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in (0, 1)
    ]
    try:
        deadline = time.time() + 120
        while time.time() < deadline:  # wait until both ranks are stepping
            logs = [f for f in os.listdir(save) if f.endswith(".log")]
            if len(logs) == 2 and all("step 3" in open(os.path.join(save, f)).read() for f in logs):
                break
            assert all(p.poll() is None for p in procs), [p.communicate()[0][-2000:] for p in procs if p.poll() is not None]
            time.sleep(0.2)
        else:
            pytest.fail("the two ranks did not start stepping")
        procs[1].send_signal(signal.SIGTERM)
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "signal 15 received" in outs[1] and "another rank was signalled" in outs[0]
    models = [f for f in os.listdir(save) if f.startswith("model_")]
    assert len(models) == 1
    n = int(models[0].split("_")[1])
    assert n >= 3 and load_checkpoint(os.path.join(save, models[0]))["iteration"] == n
    # one process resumes it
    res = _run_cli("msmctts_tpu_torch.train", "-c", cfg, "--device", "cpu", "--max-steps", "1", "--log-every", "1")
    assert res.returncode == 0, res.stderr[-3000:]
    assert find_latest_checkpoint(save).endswith(f"model_{n + 1}")


def test_mesh_node_of_the_config_is_checked(corpus):
    config = tiny_ae_config(corpus).to_dict()
    config["mesh"] = {"data": 2}
    with pytest.raises(ValueError, match="mesh.data = 2"):
        workers.build_trainer(config, {})
    config["mesh"] = {"data": -1, "model": 2}  # data x model must be the world (tensor parallelism)
    with pytest.raises(ValueError, match="mesh data 0 x model 2 needs 0 ranks; the run has 1"):
        workers.build_trainer(config, {})
    config["mesh"] = {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="mesh data 2 x model 2 needs 4 ranks; the run has 1"):
        workers.build_trainer(config, {})
    config["mesh"] = {"data": 1, "model": 1}
    assert workers.build_trainer(config, {}).world == 1


def test_a_global_batch_that_does_not_divide_the_ranks_is_refused(corpus):
    """The loss shares assume equal shards, so the loop takes no other."""
    config = tiny_ae_config(corpus).to_dict()
    config["dataloader"]["batch_size"] = 8
    trainer = workers.build_trainer(config, {})
    trainer.world = 3
    with pytest.raises(ValueError, match="batch_size 8 does not divide the 3 ranks"):
        trainer.train(max_steps=1)


# ----------------------------------------------------------------------- inference


@pytest.fixture(scope="module")
def tiny_pair(tmp_path_factory):
    """A tiny AE + AM initialised in JAX and saved as checkpoints, as in
    ``tests/test_torch_slice.py``."""
    from msmctts_tpu.models.predictor import MultiStagePredictor
    from msmctts_tpu.registry import get_network
    from msmctts_tpu.utils.checkpoint import save_checkpoint

    d = str(tmp_path_factory.mktemp("torch_parallel_pair"))
    rng = np.random.default_rng(0)
    ae_cfg = tiny_ae_config(d)
    node = ae_cfg.task["autoencoder"]
    ae = get_network(node["_name"])(**{k: v for k, v in node.items() if not k.startswith("_")})
    key = jax.random.PRNGKey(0)
    av = jax.device_get(jax.jit(lambda k: ae.init(
        {"params": k, "dropout": k}, np.zeros((1, 8, 8), np.float32), np.array([8], np.int32), deterministic=True
    ))(key))

    def gains(tree):  # audible output: the HiFi-GAN init is near-silent
        for k, v in tree.items():
            if isinstance(v, dict):
                gains(v)
            elif k == "g":
                tree[k] = rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
        return tree

    ae_path = os.path.join(d, "ae.ckpt")
    save_checkpoint(ae_path, {"params": {"autoencoder": gains(av["params"])}, "codebook": av["codebook"]}, 1, ae_cfg.to_dict())
    am_cfg = tiny_am_config(d, ae_path)
    pnode = am_cfg.task["predictor"]
    pred = MultiStagePredictor(**{k: v for k, v in pnode.items() if not k.startswith("_")})
    pv = jax.jit(lambda k: pred.init(
        k, np.ones((1, 8, 2), np.int32), np.array([8], np.int32), dur=np.ones((1, 8), np.float32), max_frames=16
    ))(key)
    am_path = os.path.join(d, "am.ckpt")
    save_checkpoint(am_path, {"params": {"predictor": MultiStagePredictor.bias_durations(jax.device_get(pv)["params"], 3.0)}},
                    1, am_cfg.to_dict())
    return am_path


def test_use_mesh_inference_on_two_ranks_matches_one_rank(tiny_pair):
    rng = np.random.default_rng(1)
    B, Lt = 4, 16
    text_length = np.array([11, 6, 16, 3])
    valid = np.arange(Lt)[None] < text_length[:, None]
    text = np.stack([rng.integers(1, 20, (B, Lt)), rng.integers(0, 5, (B, Lt))], -1) * valid[..., None]
    text_batch = {"text": text.astype(np.int32), "text_length": text_length.astype(np.int32)}
    mel_batch = {"mel": rng.normal(size=(4, 16, 8)).astype(np.float32), "mel_length": np.array([16, 9, 12, 5], np.int32)}

    task = workers.build_inference_task(tiny_pair)
    want, want_as = task.predict(text_batch), task.analysis_synthesis(mel_batch)
    res = _ranks(workers.infer_rank, 2, tiny_pair, text_batch, mel_batch)
    for r in res:  # every rank returns the whole batch, in rank order
        got = r["predict"]
        np.testing.assert_array_equal(got["duration"], want["duration"])
        np.testing.assert_array_equal(got["mel_length"], want["mel_length"])
        assert len(got["wav"]) == 4
        for a, b in zip(got["embedding"], want["embedding"]):  # snapped codewords: equal iff the indices are
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got["wav"], want["wav"]):
            assert a.shape == b.shape and a.size > 0
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        for a, b in zip(r["analysis_synthesis"]["wav"], want_as["wav"]):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        # gathers only (totals, wav, codewords, durations): the snaps communicate nothing
        assert r["collectives"]["all_reduce"]["calls"] == 0 and r["collectives"]["all_gather"]["calls"] == 4
    assert max(np.abs(w).max() for w in want["wav"]) > 1e-2
    with pytest.raises(ValueError, match="does not divide"):
        task.use_mesh(mesh.Group("gloo", 0, 2, None, None)).predict({k: v[:3] for k, v in text_batch.items()})
