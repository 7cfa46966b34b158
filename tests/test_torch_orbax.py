"""Orbax snapshots in the port (``utils/zstd.py``, ``utils/ocdbt.py``,
``utils/orbax_format.py``, ``utils/checkpoint.py``) against tensorstore,
orbax and the JAX package, on the CPU.

* zstd: the port's decoder (``csrc/zstd_decode.cc``) on the chunks that
  tensorstore's zarr driver writes at levels 1, 3, 19 and 22, and
  tensorstore reading the port's raw-block frames; the frame features
  tensorstore does not write (checksums, streamed frames without a content
  size, concatenated and skippable frames) from the ``zstandard`` module;
  malformed frames raise with a byte offset.
* OCDBT: stores tensorstore writes (its default config and one with tiny
  nodes: interior nodes, prefix-compressed keys, values out of line) read
  by the port, and stores the port writes read by tensorstore.
* the snapshot reader against ``msmctts_tpu.utils.checkpoint.load_checkpoint``
  with no target: a mixed tree, the 8-device sharded tree of
  ``tests/test_orbax_checkpoint.py`` and a JAX trainer's snapshot. A
  ``jax.Array`` leaf comes back from the port as a numpy array; every other
  leaf has the JAX reader's type.
* the snapshot writer: a port trainer's whole state read by orbax with and
  without a target.
* the port trainer with ``checkpoint_backend: orbax``: discovery, retention,
  re-saves, the writer thread's errors, resumes (from its own snapshots and
  from the JAX trainer's), and the entry points on a snapshot directory.

Tolerance: none. Every comparison is exact (bytes, dtypes, leaf types,
metrics of a step), since nothing here computes in floating point
differently on the two sides.
"""

import os
import pickle
import shutil
import sys

import jax
import numpy as np
import pytest
import tensorstore as ts
import torch
import yaml
import zstandard

from msmctts_tpu.config import component_kwargs
from msmctts_tpu.parallel.mesh import make_mesh
from msmctts_tpu.registry import get_trainer
from msmctts_tpu.tasks import build_task
from msmctts_tpu.utils.checkpoint import clean_checkpoint_directory as j_clean
from msmctts_tpu.utils.checkpoint import find_latest_checkpoint as j_find_latest
from msmctts_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from msmctts_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from msmctts_tpu.utils.checkpoint import save_checkpoint_orbax as j_save_orbax
from msmctts_tpu.utils.checkpoint import wait_for_pending_saves as j_wait
from msmctts_tpu_torch import infer as t_infer
from msmctts_tpu_torch import weights as W
from msmctts_tpu_torch.tools import as_mcd_sweep
from msmctts_tpu_torch.tools import strip_checkpoint as t_strip
from msmctts_tpu_torch.utils import orbax_format, zstd
from msmctts_tpu_torch.utils.checkpoint import (
    find_latest_checkpoint,
    load_checkpoint,
    read_checkpoint,
    save_checkpoint_orbax,
    wait_for_pending_saves,
)
from msmctts_tpu_torch.utils.ocdbt import OcdbtStore, write_store
from tests.test_torch_train_slice import _port_trainer
from tests.tiny import tiny_ae_config, write_tiny_dataset

torch.set_num_threads(2)

LEVELS = [1, 3, 19, 22]
rng0 = np.random.default_rng(0)
DATA = {
    "normal-f32-1MiB": rng0.normal(size=1 << 18).astype(np.float32),  # many compressed blocks
    "repetitive-i32": np.tile(np.arange(1000, dtype=np.int32), 300),
    "zeros": np.zeros(1 << 18, np.float32),  # RLE blocks
    "one-byte": np.array([7], np.uint8),
    "empty": np.zeros(0, np.uint8),
}


def _same(got, want, path="state"):
    """Leaf type for leaf type and bit for bit (dict keys in any order); a
    ``jax.Array`` of the JAX reader is a numpy array in the port."""
    if isinstance(want, jax.Array):
        assert type(got) is np.ndarray, (path, type(got))
        want = np.asarray(want)
    else:
        assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, list(got), list(want))
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
        assert got.tobytes() == want.tobytes(), path
    else:
        assert got == want or (got != got and want != want), (path, got, want)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


# -------------------------------------------------------------------- zstd
def _zarr(level, data):
    """A zarr v2 array with tensorstore's zstd compressor on a memory://
    kvstore holding ``data`` as one chunk."""
    spec = {"driver": "zarr", "kvstore": "memory://", "metadata": {
        "compressor": {"id": "zstd", "level": level}, "dtype": data.dtype.str,
        "shape": [data.size], "chunks": [data.size]}}
    return ts.open(spec, create=True).result()


@pytest.mark.parametrize("name", list(DATA))
@pytest.mark.parametrize("level", LEVELS)
def test_zstd_decodes_tensorstore_chunks_and_tensorstore_reads_raw_frames(level, name):
    data = DATA[name]
    if data.size == 0:  # a zarr array of no element has no chunk: the same level through zstandard
        frame = zstandard.ZstdCompressor(level=level).compress(b"")
        assert zstd.decompress(frame) == b"" and zstd.decompress(frame, 0) == bytearray()
        assert zstandard.ZstdDecompressor().decompress(zstd.compress_raw(b"")) == b""
        return
    arr = _zarr(level, data)
    arr.write(data).result()
    kv = arr.kvstore
    frame = kv.read("0").result().value
    assert frame[:4] == zstd.MAGIC
    assert zstd.decompress(frame) == data.tobytes()
    assert bytes(zstd.decompress(frame, data.nbytes)) == data.tobytes()
    # tensorstore reads the port's raw-block frame
    raw = zstd.compress_raw(data.tobytes())
    assert len(raw) == data.nbytes + 13 + 3 * -(-data.nbytes // zstd.BLOCK)
    kv.write("0", raw).result()
    np.testing.assert_array_equal(ts.open({"driver": "zarr"}, kvstore=kv, open=True).result().read().result(), data)


def test_zstd_frame_features_beyond_tensorstore():
    text = (open(__file__, "rb").read() * 20)[: 400_000]
    for level in (1, 19):
        checked = zstandard.ZstdCompressor(level=level, write_checksum=True).compress(text)
        assert checked[4] & 4  # the content-checksum flag
        assert zstd.decompress(checked) == text
        bad = checked[:-1] + bytes([checked[-1] ^ 1])
        with pytest.raises(zstd.ZstdError, match="checksum mismatch at byte"):
            zstd.decompress(bad)
    stream = zstandard.ZstdCompressor(level=3).compressobj()
    streamed = stream.compress(text) + stream.flush()  # no content size: a window descriptor
    assert not streamed[4] & 0xE0 and zstd.decompress(streamed) == text
    skip = (0x184D2A5A).to_bytes(4, "little") + (3).to_bytes(4, "little") + b"xyz"
    frames = zstandard.ZstdCompressor(level=5).compress(b"first") + skip + zstd.compress_raw(text[:1000]) + streamed
    assert zstd.decompress(frames) == b"first" + text[:1000] + text
    assert zstd.crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("fault", ["truncated", "bad-magic", "reserved-bit", "corrupt-block", "short-size"])
def test_zstd_malformed_frames_raise_with_the_byte_offset(fault):
    good = zstandard.ZstdCompressor(level=3).compress(open(__file__, "rb").read())
    frame = {
        "truncated": good[: len(good) // 2],
        "bad-magic": b"\x00" + good[1:],
        "reserved-bit": good[:4] + bytes([good[4] | 8]) + good[5:],
        "corrupt-block": good[:40] + bytes(b ^ 0x5A for b in good[40:80]) + good[80:],
        "short-size": good,
    }[fault]
    with pytest.raises(zstd.ZstdError, match=r"at byte \d+"):
        if fault == "short-size":  # a frame that decodes to other than the size asked for
            zstd.decompress(frame, len(open(__file__, "rb").read()) - 1)
        else:
            zstd.decompress(frame)


# ------------------------------------------------------------------- OCDBT
def _items(n, seed=0):
    rng = np.random.default_rng(seed)
    items = {f"key{i:03d}/{'x' * (i % 3)}".encode(): rng.integers(0, 256, int(rng.choice([0, 5, 1024, 1025, 3000])),
                                                                   dtype=np.uint8).tobytes() for i in range(n)}
    items[b"params.b.c/0"] = b"abc"
    return items


@pytest.mark.parametrize("config", [{}, {"max_decoded_node_bytes": 200, "max_inline_value_bytes": 8}],
                         ids=["orbax-config", "tiny-nodes"])
def test_ocdbt_reads_tensorstore_stores(tmp_path, config):
    items = _items(60)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/", "config": config}).result()
    with ts.Transaction() as txn:
        for k, v in items.items():
            kv.with_transaction(txn)[k] = v
    store = OcdbtStore(str(tmp_path))
    assert list(store.keys()) == sorted(items)
    for k, v in items.items():
        assert store.read(k) == v, k


@pytest.mark.parametrize("limit", [100_000_000, 300], ids=["one-leaf", "split-nodes"])
def test_tensorstore_reads_the_ocdbt_store_the_port_writes(tmp_path, limit):
    items = _items(80, seed=1)
    write_store(str(tmp_path), items, max_decoded_node_bytes=limit)
    assert len(os.listdir(tmp_path / "d")) == 1  # one data file: values and nodes
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/"}).result()
    assert sorted(bytes(k) for k in kv.list().result()) == sorted(items)
    for k, v in items.items():
        assert kv.read(k).result().value == v, k
    assert OcdbtStore(str(tmp_path)).read(b"params.b.c/0") == b"abc"


@pytest.mark.parametrize("case", ["ragged-chunks", "missing-chunk", "f-order"])
def test_zarr_arrays_assemble_from_their_chunks(tmp_path, case):
    """A zarr v2 array that tensorstore writes through OCDBT in several
    chunks, the last ones partial, read by the port's reader; a chunk
    missing under ``fill_value: null`` and an order it does not read raise
    with their names."""
    data = np.arange(30, dtype=np.float32).reshape(10, 3)
    meta = {"compressor": {"id": "zstd", "level": 3}, "dtype": "<f4", "shape": [10, 3], "chunks": [4, 2],
            "order": "F" if case == "f-order" else "C"}
    arr = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/"}, "path": "a.b",
                   "metadata": meta}, create=True).result()
    arr.write(data).result()
    store = OcdbtStore(str(tmp_path))
    assert sum(k.startswith(b"a.b/") and not k.endswith(b".zarray") for k in store.keys()) == 6
    if case == "ragged-chunks":
        np.testing.assert_array_equal(orbax_format._read_array(store, "a.b", "test"), data)
    elif case == "f-order":
        with pytest.raises(orbax_format.SnapshotError, match="order 'F'"):
            orbax_format._read_array(store, "a.b", "test")
    else:
        store._index.pop(b"a.b/2.1")
        with pytest.raises(orbax_format.SnapshotError, match="chunk a.b/2.1 is missing"):
            orbax_format._read_array(store, "a.b", "test")


# ------------------------------------------------------------ snapshot reader
def _mixed_tree():
    rng = np.random.default_rng(2)
    return {
        "params": {"w": rng.normal(size=(300, 1000)).astype(np.float32), "b.c": np.ones((), np.float16),
                   "h": rng.normal(size=(5,)).astype(np.float16), "d": np.arange(4.0)},
        "i32": np.arange(3000, dtype=np.int32), "i64": np.int64(7), "u32": np.arange(5, dtype=np.uint32),
        "u8": np.arange(9, dtype=np.uint8), "mask": np.array([True, False, True]),
        "lst": [np.int32(1), 2.5, True, None, (np.zeros(3, bool), 4)], "opt": {0: np.ones(2), 3: 5},
        "empty": {}, "none": None, "scalar": np.float32(1.5),
    }


def _jax_snapshot(path, tree):
    j_save_orbax(path, tree, 3, {"id": "x"})
    j_wait()
    return j_load_checkpoint(path)


def test_reader_matches_jax_on_a_mixed_tree(tmp_path):
    path = str(tmp_path / "model_3")
    want = _jax_snapshot(path, _mixed_tree())
    got = read_checkpoint(path)
    assert (got["iteration"], got["config"], got["format"]) == (3, {"id": "x"}, "msmctts_tpu/orbax-v1")
    _same(got["state"], want["state"])
    assert isinstance(got["state"]["lst"], list) and list(got["state"]["opt"]) == ["0", "3"]
    # load_checkpoint upcasts float leaves as it does for pickles
    up = load_checkpoint(path)["state"]
    assert up["params"]["h"].dtype == np.float32 and up["params"]["d"].dtype == np.float32
    assert up["i32"].dtype == np.int32 and type(up["lst"][1]) is float


def test_reader_matches_jax_on_the_sharded_tree(tmp_path):
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    mesh = make_mesh()
    n = len(jax.devices())
    assert n == 8
    tree = {"params": {"w": jax.device_put(np.arange(n * 4, dtype=np.float32).reshape(n, 4), NamedSharding(mesh, P("data"))),
                       "b": jax.device_put(np.full((3,), 2.5, np.float32), NamedSharding(mesh, P()))}}
    path = str(tmp_path / "model_7")
    want = _jax_snapshot(path, tree)
    store = OcdbtStore(os.path.join(path, "state"))
    assert [k for k in store.keys() if k.startswith(b"params.w/") and not k.endswith(b"zarray")] == [
        f"params.w/{i}.0".encode() for i in range(n)]  # one chunk per shard
    _same(read_checkpoint(path)["state"], want["state"])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("orbax_corpus"))
    write_tiny_dataset(d)
    return d


def _jax_trainer(config):
    return get_trainer("VQGANTrainer")(config, build_task(config, mode="train"), mesh=make_mesh(1),
                                       **component_kwargs(config.trainer))


@pytest.fixture(scope="module")
def jax_run(corpus, tmp_path_factory):
    """The JAX trainer's orbax snapshot after one step, and a pickle of the
    same state."""
    d = str(tmp_path_factory.mktemp("jax_orbax_run"))
    config = tiny_ae_config(corpus)
    config["checkpoint_backend"] = "orbax"
    config["save_checkpoint_dir"] = os.path.join(d, "ckpt")
    with jax.default_matmul_precision("highest"):
        _jax_trainer(config).train(max_steps=1, log_every=1)
    snapshot = os.path.join(config["save_checkpoint_dir"], "model_1")
    want = j_load_checkpoint(snapshot)
    pickled = os.path.join(d, "model_1.ckpt")
    j_save_checkpoint(pickled, want["state"], 1, want["config"])
    return dict(config=config, snapshot=snapshot, want=want, pickle=pickled, dir=d)


def test_reader_matches_jax_on_a_trainer_snapshot(jax_run):
    got = read_checkpoint(jax_run["snapshot"])
    want = jax_run["want"]
    assert (got["iteration"], got["config"]) == (want["iteration"], want["config"]) == (1, jax_run["config"].to_dict())
    _same(got["state"], want["state"])
    assert {"params", "codebook", "opt_state"} <= set(got["state"])


def test_resume_from_the_jax_trainer_snapshot_matches_jax_resume(jax_run, corpus):
    config = jax_run["config"]
    with jax.default_matmul_precision("highest"):
        jt = _jax_trainer(config)
        from msmctts_tpu.data.loader import DataLoader as JDataLoader
        from msmctts_tpu.training.base_trainer import build_dataset_from_config as j_build_dataset

        batch = next(iter(JDataLoader(j_build_dataset(config, training=True), batch_size=4, num_workers=0)))
        jt.attempt_resume(jax.random.PRNGKey(0), {k: batch[k] for k in ("mel", "mel_length", "wav")})
        want = jax.device_get(jt.state)
    trainer = _port_trainer(config.to_dict())
    trainer.attempt_resume()
    assert trainer.iteration == jt.iteration == 1
    got = W.train_state_to_jax(trainer.ae, trainer.disc)
    for key in ("params", "codebook"):
        flat_got, flat_want = dict(_leaves(got[key])), dict(_leaves(want[key]))
        assert sorted(flat_got) == sorted(flat_want)
        for k, v in flat_want.items():
            np.testing.assert_array_equal(flat_got[k], np.asarray(v), err_msg=k)
    assert (trainer.ae_opt.count, trainer.d_opt.count) == (1, 0)  # no optimizer state of this stack


def test_infer_on_a_jax_snapshot_equals_infer_on_its_pickle(jax_run, corpus, tmp_path):
    cfg = dict(jax_run["config"].to_dict(), save_features=[["wav", ".npy"]])
    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    test_list = str(tmp_path / "test.yaml")
    with open(test_list, "w") as f:
        yaml.safe_dump({u: {"mel": f"{corpus}/mel/{u}.npy"} for u in ("utt000", "utt001")}, f)
    outs = {}
    for name in ("snapshot", "pickle"):
        outs[name] = t_infer.main(["-m", jax_run[name], "-c", cfg_path, "-t", test_list, "-o", str(tmp_path / name),
                                   "--device", "cpu"])
    for u in ("utt000", "utt001"):
        a, b = (np.load(os.path.join(outs[n], f"{u}_wav.npy")) for n in ("snapshot", "pickle"))
        assert a.size > 0 and a.tobytes() == b.tobytes(), u


def test_strip_of_a_snapshot_matches_the_jax_tool(jax_run, tmp_path, monkeypatch):
    import tools.strip_checkpoint as j_strip

    got_path, want_path = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    t_strip.main([jax_run["snapshot"], "-o", got_path])
    monkeypatch.setattr(sys, "argv", ["strip_checkpoint.py", jax_run["snapshot"], "-o", want_path])
    j_strip.main()
    with open(got_path, "rb") as f:
        got = pickle.load(f)
    want = j_load_checkpoint(want_path)
    assert (got["iteration"], got["format"], got["config"]) == (want["iteration"], want["format"], want["config"])
    _same(got["state"], want["state"])
    assert "discriminator" not in got["state"]["params"] and "opt_state" not in got["state"]


# ------------------------------------------------------------ snapshot writer
@pytest.fixture(scope="module")
def port_state(corpus):
    """A tiny port trainer's whole state after 3 steps (warmup and GAN),
    ``torch_opt_state`` and ``torch_rng`` included, as ``save`` hands it to
    the writer."""
    config = tiny_ae_config(corpus)
    trainer = _port_trainer(dict(config.to_dict(), save_checkpoint_dir=os.path.join(corpus, "port_state")))
    trainer.train(max_steps=3, log_every=3)
    return read_checkpoint(find_latest_checkpoint(trainer.save_dir))


@pytest.mark.parametrize("target", [False, True], ids=["no-target", "target"])
def test_orbax_restores_the_snapshot_the_port_writes(port_state, tmp_path, target):
    path = save_checkpoint_orbax(str(tmp_path / "model_3"), port_state["state"], 3, port_state["config"])
    wait_for_pending_saves()
    assert sorted(os.listdir(path)) == ["meta.pkl", "state"]
    if not target:
        want = j_load_checkpoint(path)["state"]
        _same(read_checkpoint(path)["state"], want)  # the port reads back what orbax restores
        opt = want["torch_opt_state"]["autoencoder"]["opt"]
        assert list(opt["state"])[:2] == ["0", "1"] and isinstance(opt["param_groups"][0]["betas"], list)
        return
    tree = port_state["state"]
    restored = j_load_checkpoint(path, target=tree)["state"]
    flat_got, flat_want = dict(_leaves(restored)), dict(_leaves(tree))
    assert sorted(flat_got) == sorted(flat_want) and len(flat_want) > 100
    for k, v in flat_want.items():
        if isinstance(v, np.ndarray):
            g = np.asarray(flat_got[k])
            assert g.dtype == v.dtype and g.shape == v.shape and g.tobytes() == v.tobytes(), k
        else:
            assert flat_got[k] == v and type(flat_got[k]) is type(v), k


# ------------------------------------------------- the port trainer, orbax
def _orbax_config(corpus, save_dir, **extra):
    return {**tiny_ae_config(corpus).to_dict(), "checkpoint_backend": "orbax", "save_checkpoint_dir": str(save_dir),
            **extra}


def test_discovery_skips_a_snapshot_whose_state_is_in_flight(tmp_path):
    d = tmp_path / "ckpt"
    d.mkdir()
    with open(d / "model_3", "wb") as f:
        pickle.dump({"format": "msmctts_tpu/v1"}, f)
    os.makedirs(d / "model_5")  # meta.pkl renamed into place, state/ not yet committed
    (d / "model_5" / "meta.pkl").write_bytes(b"")
    os.makedirs(d / "model_9.tmp")
    assert find_latest_checkpoint(str(d)) == j_find_latest(str(d)) == str(d / "model_3")
    assert sorted(as_mcd_sweep.find_snapshots(str(d))) == [3]
    os.makedirs(d / "model_5" / "state")
    assert find_latest_checkpoint(str(d)) == j_find_latest(str(d)) == str(d / "model_5")
    assert sorted(as_mcd_sweep.find_snapshots(str(d))) == [3, 5]


def test_retention_over_snapshot_directories_matches_jax(corpus, tmp_path):
    config = _orbax_config(corpus, tmp_path / "ckpt", iters_per_checkpoint=1, checkpoint_keep_interval=2)
    _port_trainer(config).train(max_steps=5, log_every=5)
    got = sorted(n for n in os.listdir(tmp_path / "ckpt") if n.startswith("model_"))
    ref = tmp_path / "jax"
    ref.mkdir()
    for it in range(1, 6):  # the JAX trainer's save: a snapshot directory, then the clean
        os.makedirs(ref / f"model_{it}" / "state")
        (ref / f"model_{it}" / "meta.pkl").write_bytes(b"")
        j_clean(str(ref), 2)
    assert got == sorted(os.listdir(ref)) == ["model_2", "model_4", "model_5"]
    assert all(os.path.isdir(tmp_path / "ckpt" / n / "state") for n in got)


def test_a_resave_to_the_same_path_replaces_the_snapshot(tmp_path):
    path = str(tmp_path / "model_300")
    a = {"codebook": {"embed": np.zeros((2, 4), np.float32)}}
    b = {"codebook": {"embed": np.full((2, 4), 7.0, np.float32)}, "extra": [1, 2]}
    save_checkpoint_orbax(path, a, 300, {"id": "first"})
    save_checkpoint_orbax(path, b, 300, {"id": "second"})  # while the first may still be in flight
    got = read_checkpoint(path)
    assert got["config"] == {"id": "second"}
    _same(got["state"], {"codebook": {"embed": b["codebook"]["embed"]}, "extra": [1, 2]})
    assert sorted(os.listdir(tmp_path)) == ["model_300"]


def test_the_writer_thread_error_is_raised_once(tmp_path, monkeypatch):
    def broken(state_dir, tree):
        raise OSError("disk full")

    monkeypatch.setattr(orbax_format, "write_snapshot", broken)
    path = save_checkpoint_orbax(str(tmp_path / "model_1"), {"a": np.ones(2)}, 1, {})
    with pytest.raises(RuntimeError, match="disk full"):
        wait_for_pending_saves()
    wait_for_pending_saves()  # raised once, not again
    assert not os.path.isdir(os.path.join(path, "state")) and find_latest_checkpoint(str(tmp_path)) is None


def test_a_relative_snapshot_path_is_resolved(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = save_checkpoint_orbax("model_2", {"a": np.arange(3)}, 2, {})
    assert path == str(tmp_path / "model_2")
    assert read_checkpoint("model_2")["state"]["a"].tolist() == [0, 1, 2]
    with pytest.raises(FileNotFoundError, match="without meta.pkl"):
        read_checkpoint(".")


def _recorded(trainer, log):
    step = trainer.train_step

    def run(*args, **kwargs):
        out = step(*args, **kwargs)
        log.append({k: float(v) for k, v in out.items()})
        return out

    trainer.train_step = run
    return trainer


def test_the_step_after_an_orbax_resume_equals_the_step_after_a_pickle_resume(port_state, corpus, tmp_path):
    """The same state (3 steps in, both optimizers live) as a pickle and as
    a snapshot: after ``load`` the Adam moments are equal, under int keys and
    with ``betas`` a tuple; one more step through ``train()`` from each gives
    bit-equal metrics and a bit-equal state."""
    dirs = {b: tmp_path / b for b in ("pickle", "orbax")}
    dirs["pickle"].mkdir()
    shutil.copy(find_latest_checkpoint(os.path.join(corpus, "port_state")), dirs["pickle"] / "model_3")
    save_checkpoint_orbax(str(dirs["orbax"] / "model_3"), port_state["state"], 3, port_state["config"])
    trainers, metrics = {}, {}
    for backend, d in dirs.items():
        config = _orbax_config(corpus, d, checkpoint_backend=backend)
        loaded = _port_trainer(config)
        loaded.init_state()
        loaded.load(str(d / "model_3"))
        trainers[backend] = loaded
        metrics[backend] = []
        _recorded(_port_trainer(config), metrics[backend]).train(max_steps=1, log_every=1)
    for name in ("autoencoder", "discriminator"):
        a, b = (trainers[k].optimizers[name].opt.state_dict() for k in ("pickle", "orbax"))
        assert a["param_groups"] == b["param_groups"] and isinstance(b["param_groups"][0]["betas"], tuple)
        assert sorted(b["state"]) == sorted(a["state"]) == list(range(len(a["state"]))) and a["state"]
        for i, s in a["state"].items():
            for k, v in s.items():
                assert torch.equal(v, b["state"][i][k]), (name, i, k)
        assert trainers["orbax"].optimizers[name].count == trainers["pickle"].optimizers[name].count
    assert torch.equal(trainers["orbax"].generator.get_state(), trainers["pickle"].generator.get_state())
    assert len(metrics["orbax"]) == 1 and metrics["orbax"] == metrics["pickle"]
    assert "fm_loss" in metrics["orbax"][0]
    after = {b: read_checkpoint(str(d / "model_4"))["state"] for b, d in dirs.items()}
    assert os.path.isdir(dirs["orbax"] / "model_4" / "state")
    # paths as strings: an int key or a tuple of the pickle reads the same as its snapshot's string key or list
    flat_p, flat_o = dict(_leaves(after["pickle"])), dict(_leaves(after["orbax"]))
    assert sorted(flat_p) == sorted(flat_o)
    for k, v in flat_p.items():
        if isinstance(v, np.ndarray):
            assert flat_o[k].tobytes() == v.tobytes() and flat_o[k].dtype == v.dtype, k
        else:
            assert flat_o[k] == v, k


@pytest.mark.parametrize("tree", ["fixture-f16", "normal-f32"])
def test_snapshot_size_against_orbax_level_1(tmp_path, tree, capsys):
    """The port's raw-block snapshot against orbax's zstd level 1 of the same
    tree: larger by what level 1 saves (trained float16 weights, random
    normal float32), and never smaller than the data."""
    if tree == "fixture-f16":
        state = read_checkpoint(os.path.join(os.path.dirname(__file__), "fixtures", "csmsc_ae_r5.f16.ckpt"))["state"]
    else:
        state = {"w": np.random.default_rng(5).normal(size=(8, 1 << 18)).astype(np.float32)}
    data = sum(v.nbytes for _, v in _leaves(state))
    sizes = {}
    for name, save, wait in (("port", save_checkpoint_orbax, wait_for_pending_saves), ("orbax", j_save_orbax, j_wait)):
        path = str(tmp_path / name)
        save(path, state, 1, {})
        wait()
        sizes[name] = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(os.path.join(path, "state"))
                          for f in fs)
    ratio = sizes["port"] / sizes["orbax"]
    with capsys.disabled():
        print(f"\n{tree}: data {data} bytes, port {sizes['port']}, orbax level 1 {sizes['orbax']}, ratio {ratio:.4f}")
    assert data < sizes["port"] < 1.01 * data + 65536
    assert 1.0 < ratio < 1.25
