"""The port's train feed against msmctts_tpu, on the CPU: the native bulk
reader (``data/native.py`` over ``csrc/msmc_io.cc``), ``parse_cases``, the
wire format (``data/wire.py``) and the device prefetcher, then the training
loop that reads ``dataloader.wire_compression`` and ``device_prefetch``.

Tolerances.
  * readers, ``parse_cases``, ``encode_batch`` / ``decode_batch``: bit-equal
    (the same C++ source and the same numpy rule on the same files).
  * ``train()`` against the JAX package's ``train()``, 2 GAN steps from one
    JAX init, whole utterances (no random windows), dropout 0: the train
    slice's tolerances (``tests/test_torch_train_slice.py``): metrics 2e-5
    relative, codebook 2e-5, each parameter within ``2 * lr * steps``.
    Before the port read the two keys, both cases failed: a waveform off the
    int16 grid (32-bit PCM) that JAX rounds under ``true``, and the mel that
    JAX rounds to bf16 under ``"full"``.
"""

import os

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from msmctts_tpu.config import component_kwargs
from msmctts_tpu.data import native as j_native
from msmctts_tpu.data import wire as j_wire
from msmctts_tpu.data.datasets import save_wav as j_save_wav
from msmctts_tpu.parallel.mesh import make_mesh
from msmctts_tpu.registry import get_trainer
from msmctts_tpu.tasks import build_task
from msmctts_tpu.training.base_trainer import build_dataset_from_config as j_build_dataset
from msmctts_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from msmctts_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from msmctts_tpu_torch.config import Config as TConfig
from msmctts_tpu_torch.config import component_kwargs as t_component_kwargs
from msmctts_tpu_torch.data import native, wire
from msmctts_tpu_torch.data.datasets import load_wav
from msmctts_tpu_torch.data.loader import DataLoader as TDataLoader
from msmctts_tpu_torch.registry import get_trainer as t_get_trainer
from msmctts_tpu_torch.tasks import build_task as t_build_task
from msmctts_tpu_torch.training.base_trainer import build_dataset_from_config as t_build_dataset
from tests.tiny import FRAMESHIFT, MEL_DIM, tiny_ae_config, tiny_am_config, write_tiny_dataset

torch.set_num_threads(2)

LR = 2e-4
STEPS = 2
WINDOW = 16  # frames of every utterance of the train() corpus
METRIC_RTOL = 2e-5
CODEBOOK_TOL = 2e-5


# ------------------------------------------------------------ the reader


def test_the_native_reader_builds():
    assert native.native_available() and j_native.native_available()
    assert native.library_path().exists() and native.library_path().parent.name == "msmctts_tpu_torch"


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64"])
def test_read_npy_matches_jax(tmp_path, dtype):
    rng = np.random.default_rng(0)
    arr = (rng.normal(size=(50, 9)) * 10).astype(dtype)
    p = str(tmp_path / "a.npy")
    np.save(p, arr)
    for start, count in ((0, -1), (10, 5), (45, -1), (48, 10)):
        got = native.read_npy(p, row_start=start, row_count=count)
        want = j_native.read_npy(p, row_start=start, row_count=count)
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes(), (start, count)
        np.testing.assert_array_equal(got, arr.astype(np.float32)[start: None if count < 0 else start + count])


def test_read_npy_1d_and_fortran_order_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    one = rng.normal(size=(33,)).astype(np.float32)
    fortran = np.asfortranarray(rng.normal(size=(17, 6)).astype(np.float32))
    for name, arr in (("one", one), ("fortran", fortran)):
        p = str(tmp_path / f"{name}.npy")
        np.save(p, arr)
        got, want = native.read_npy(p), j_native.read_npy(p)
        assert got.shape == arr.shape and got.tobytes() == want.tobytes(), name
        np.testing.assert_array_equal(got, arr)
    # a row slice of a Fortran-order file is refused by both
    with pytest.raises(IOError):
        native.read_npy(str(tmp_path / "fortran.npy"), row_start=2, row_count=3)
    with pytest.raises(IOError):
        j_native.read_npy(str(tmp_path / "fortran.npy"), row_start=2, row_count=3)


@pytest.mark.parametrize("bits", [16, 32])
def test_read_wav_matches_jax_and_scipy(tmp_path, bits):
    rng = np.random.default_rng(2)
    p = str(tmp_path / "x.wav")
    if bits == 16:
        j_save_wav(p, (rng.normal(size=4000) * 0.3).astype(np.float32), 16000)
    else:
        wavfile.write(p, 16000, (rng.normal(size=4000) * 0.2 * 2**31).astype(np.int32))
    got, sr = native.read_wav(p)
    want, jsr = j_native.read_wav(p)
    assert sr == jsr == 16000 and got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(got, load_wav(p))


def test_read_batch_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    paths, kinds = [], []
    for i in range(12):
        if i % 2 == 0:
            p = str(tmp_path / f"f{i}.npy")
            np.save(p, rng.normal(size=(20 + i, 4)).astype(np.float32))
        else:
            p = str(tmp_path / f"f{i}.wav")
            j_save_wav(p, (rng.normal(size=1000 + i) * 0.2).astype(np.float32), 8000)
        paths.append(p)
        kinds.append(i % 2)
    before = native.batch_reads()
    got, srs = native.read_batch(paths, kinds, n_threads=4)
    want, jsrs = j_native.read_batch(paths, kinds, n_threads=4)
    assert native.batch_reads() == before + 1 and srs == jsrs == [0, 8000] * 6
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()


# ----------------------------------------------------------- parse_cases


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("feed_corpus"))
    write_tiny_dataset(d)
    return d


def _cases_equal(a, b):
    assert [sorted(x) for x in a] == [sorted(y) for y in b]
    for x, y in zip(a, b):
        for k in x:
            assert np.asarray(x[k]).dtype == np.asarray(y[k]).dtype and np.array_equal(x[k], y[k]), k


@pytest.mark.parametrize("recipe", ["ae", "am"])
def test_parse_cases_equals_per_file_and_jax(corpus, recipe):
    config = tiny_ae_config(corpus) if recipe == "ae" else tiny_am_config(corpus, "unused")
    config["dataset"]["segment_length"] = 48 if recipe == "ae" else -1  # the crop draws from the dataset's rng
    build = lambda: t_build_dataset(TConfig(config.to_dict()), training=True)
    indices = [5, 0, 3, 3, 7]
    before = native.batch_reads()
    bulk = build().parse_cases(indices)
    assert native.batch_reads() == before + 1
    per_file = build()
    _cases_equal(bulk, [per_file.parse_case(i % len(per_file.id_list)) for i in indices])
    _cases_equal(bulk, j_build_dataset(config, training=True).parse_cases(indices))


def test_parse_cases_falls_back_and_checks_the_sample_rate(corpus, tmp_path):
    config = tiny_ae_config(corpus)
    ds = t_build_dataset(TConfig(config.to_dict()), training=False)
    # a float16 npy, which the C++ parser rejects: this batch reads file by file
    odd = str(tmp_path / "odd.npy")
    np.save(odd, np.load(ds.dataset[(ds.id_list[0], "mel")]).astype(np.float16))
    ds.dataset[(ds.id_list[0], "mel")] = odd
    before = native.batch_reads()
    got = ds.parse_cases([0, 1])
    assert native.batch_reads() == before
    _cases_equal(got, [ds.parse_case(0), ds.parse_case(1)])
    ds.samplerate = 8000
    with pytest.raises(ValueError, match="sample rate mismatch"):
        ds.parse_cases([1])


def test_the_loader_collates_through_parse_cases(corpus):
    ds = t_build_dataset(TConfig(tiny_ae_config(corpus).to_dict()), training=True)
    before = native.batch_reads()
    it = iter(TDataLoader(ds, batch_size=4, num_workers=0))
    next(it), next(it)
    assert native.batch_reads() == before + 2


# ---------------------------------------------------------- wire format


def _jax_encoded(batch, mode):
    return j_wire.encode_batch(batch, mode)


def _bits(x):
    """A tensor's or array's bytes (a bf16 tensor as its uint16 pattern)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    x = np.asarray(x)
    return (x.view(np.uint16) if x.dtype.name == "bfloat16" else x).tobytes()


@pytest.mark.parametrize("mode", [False, True, "full"], ids=["off", "wav", "full"])
def test_encode_decode_bit_equal_to_jax(mode):
    rng = np.random.default_rng(4)
    batch = {
        "mel": rng.normal(size=(2, 8, 4)).astype(np.float32),
        "pitch": rng.normal(size=(2, 8, 1)).astype(np.float32),
        # clipped values, ties half-way between grid steps (rounded half to even), then values on the grid
        "wav": np.concatenate([rng.uniform(-1.2, 1.2, size=(2, 54)), np.tile([0.5, 1.5, 2.5, -0.5, -1.5, -32767.5], (2, 1))
                               / 32768.0, rng.integers(-32768, 32768, size=(2, 4)) / 32768.0], axis=1).astype(np.float32),
        "mel_length": np.array([8, 6], np.int32),
    }
    got = wire.encode_batch(batch, mode)
    want = _jax_encoded(batch, mode)
    for k in batch:
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype) or k == "mel_length", (k, got[k].dtype)
        if k != "mel_length":
            assert _bits(got[k]) == _bits(want[k]), k
    assert got["mel_length"].dtype == torch.int64
    dec = wire.decode_batch(got)
    jdec = j_wire.decode_batch({k: jax.numpy.asarray(v) for k, v in want.items()})
    for k in ("mel", "pitch", "wav"):
        assert dec[k].dtype == torch.float32 and dec[k].numpy().tobytes() == np.asarray(jdec[k]).tobytes(), k
    if mode:
        assert got["wav"].dtype == torch.int16 and dec["wav"][:, 60:].numpy().tobytes() == batch["wav"][:, 60:].tobytes()


def test_decode_is_keyed_not_dtype_keyed():
    """As ``tests/test_wire.py::test_decode_keyed_not_dtype_keyed``: an int16
    or bf16 tensor under another key passes through untouched."""
    tokens = torch.arange(12, dtype=torch.int16).reshape(3, 4)
    flags = torch.ones(3, dtype=torch.bfloat16)
    dec = wire.decode_batch({"tokens": tokens, "flags": flags, "wav": flags})
    assert dec["tokens"] is tokens and dec["flags"] is flags and dec["wav"] is flags


@pytest.mark.parametrize("depth", [2, 0], ids=["thread", "inline"])
def test_prefetcher_order_and_errors(depth):
    batches = [{"wav": np.full((2, 8), i / 32768.0, np.float32), "mel_length": np.array([8, 8])} for i in range(5)]
    pf = wire.DevicePrefetcher(iter(batches), "cpu", mode=True, depth=depth)
    got = [next(pf) for _ in range(5)]
    for i, b in enumerate(got):
        assert b["wav"].dtype == torch.int16 and int(b["wav"][0, 0]) == i
        assert b["mel_length"].dtype == torch.int64
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()

    def boom():
        yield batches[0]
        raise RuntimeError("loader died")

    pf = wire.DevicePrefetcher(boom(), "cpu", mode=True, depth=depth)
    next(pf)
    for _ in range(2):  # and again: the error stays
        with pytest.raises(RuntimeError, match="loader died"):
            next(pf)
    pf.close()


def test_prefetcher_close_releases_the_worker():
    def endless():
        i = 0
        while True:
            yield {"wav": np.zeros((1, 4), np.float32) + i / 32768.0}
            i += 1

    pf = wire.DevicePrefetcher(endless(), "cpu", depth=2)
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()


# ----------------------------------------------------- train() vs JAX


def _fixed_corpus(d, pcm32: bool):
    """The tiny corpus with every utterance WINDOW frames long, so that the
    GAN step's window is the utterance in both stacks (every start 0); with
    ``pcm32`` the waveforms are quiet 32-bit PCM (peak near 2e-3), whose
    values JAX's load_wav divides by 2^31: off the int16 grid, by up to
    half a step of it (1.5e-5) where the signal is some 5e-4."""
    write_tiny_dataset(d)
    rng = np.random.default_rng(5)
    for name in sorted(os.listdir(os.path.join(d, "mel"))):
        uid = name[: -len(".npy")]
        np.save(os.path.join(d, "mel", name), rng.normal(size=(WINDOW, MEL_DIM)).astype(np.float32))
        wav = rng.normal(size=WINDOW * FRAMESHIFT) * 0.1
        path = os.path.join(d, "wav", uid + ".wav")
        if pcm32:  # a quiet take: the int16 grid is coarse against it
            wavfile.write(path, 1600, (wav * 0.005 * 2**31).astype(np.int32))
        else:
            j_save_wav(path, wav.astype(np.float32), 1600)
    return d


def _config(corpus, mode, save_dir):
    config = tiny_ae_config(corpus)
    ae = config["task"]["autoencoder"]
    for node in (ae["encoder_config"], ae["frame_decoder_config"]):
        node["dropout"] = 0.0
    ae["quantizer_config"]["dropout"] = 0.0
    ae["quantizer_config"]["prior_config"]["p_dropout"] = 0.0
    config["trainer"]["warmup_steps"] = 0  # GAN steps from the first
    config["trainer"]["sample_lengths"] = WINDOW * FRAMESHIFT  # the whole utterance: every start 0
    config["dataloader"]["wire_compression"] = mode
    config["save_checkpoint_dir"] = save_dir
    return config


def _recorded(step, log, unpack):
    def run(*args, **kwargs):
        out = step(*args, **kwargs)
        log.append(unpack(out))
        return out

    return run


@pytest.mark.parametrize("case", ["pcm32-wire-true", "tiny-wire-full"])
def test_train_matches_jax_train_on_the_wire(tmp_path, case):
    corpus = str(tmp_path / "corpus")
    mode = True if case == "pcm32-wire-true" else "full"
    _fixed_corpus(corpus, pcm32=mode is True)
    with jax.default_matmul_precision("highest"):
        # one init for both stacks, handed over as a pretrain checkpoint
        config = _config(corpus, mode, str(tmp_path / "jax"))
        jtask = build_task(config, mode="train")
        jtrainer = get_trainer("VQGANTrainer")(config, jtask, mesh=make_mesh(1), **component_kwargs(config.trainer))
        sample = next(iter(jax_loader(config)))
        state = jax.device_get(jtrainer.init_state(jax.random.PRNGKey(0), sample))
        init = str(tmp_path / "init.ckpt")
        j_save_checkpoint(init, {k: state[k] for k in ("params", "codebook", "model_state") if k in state}, 0,
                          config.to_dict())
        config["pretrain_checkpoint_path"] = init
        jtrainer = get_trainer("VQGANTrainer")(config, build_task(config, mode="train"), mesh=make_mesh(1),
                                               **component_kwargs(config.trainer))
        j_metrics = []
        jtrainer.train_step = _recorded(jtrainer.train_step, j_metrics, lambda out: out[1].to_host())
        jtrainer.train(max_steps=STEPS, log_every=1)
        want = j_load_checkpoint(os.path.join(config["save_checkpoint_dir"], f"model_{STEPS}"))["state"]

    tconfig = dict(config.to_dict(), save_checkpoint_dir=str(tmp_path / "torch"))
    cfg = TConfig(tconfig)
    trainer = t_get_trainer("VQGANTrainer")(cfg, t_build_task(cfg, device="cpu", mode="train"),
                                           **t_component_kwargs(cfg.trainer))
    t_metrics = []
    trainer.train_step = _recorded(trainer.train_step, t_metrics, lambda m: {k: float(v) for k, v in m.items()})
    trainer.train(max_steps=STEPS, log_every=1)
    got = j_load_checkpoint(os.path.join(tconfig["save_checkpoint_dir"], f"model_{STEPS}"))["state"]

    assert len(j_metrics) == len(t_metrics) == STEPS
    for it, (g, w) in enumerate(zip(t_metrics, j_metrics), 1):
        assert set(g) == set(w)
        for k in w:
            assert g[k] == pytest.approx(float(w[k]), rel=METRIC_RTOL, abs=1e-6), (it, k, g[k], float(w[k]))
    _codebooks_close(got["codebook"], want["codebook"])
    _params_close(got["params"], want["params"], 2 * LR * STEPS)


def jax_loader(config):
    from msmctts_tpu.data.loader import DataLoader

    return DataLoader(j_build_dataset(config, training=True), batch_size=4, num_workers=0)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _codebooks_close(got, want):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w) and w
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=CODEBOOK_TOL, atol=CODEBOOK_TOL, err_msg=k)


def _params_close(got, want, atol):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w) and w
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol, err_msg=k)
