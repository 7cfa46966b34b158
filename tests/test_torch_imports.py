"""The PyTorch port stands alone: no module of ``msmctts_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, flax, optax or the JAX package, and its
entry points refuse to fall back to the CPU unless asked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "msmctts_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msmctts_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_forbidden_names_are_recognised():
    assert _forbidden("jax.numpy") and _forbidden("msmctts_tpu.config")
    assert _forbidden("flax.linen") and _forbidden("optax")
    assert not _forbidden("msmctts_tpu_torch.ops.vq") and not _forbidden("torch")


def test_scan_covers_the_training_slice():
    """The scan and the subprocess import below walk the package's tree;
    the training slice's modules must be in it."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    for rel in (
        "msmctts_tpu_torch/train.py", "msmctts_tpu_torch/ops/stft.py", "msmctts_tpu_torch/ops/dropout.py",
        "msmctts_tpu_torch/data/loader.py", "msmctts_tpu_torch/data/datasets.py",
        "msmctts_tpu_torch/training/__init__.py", "msmctts_tpu_torch/training/losses.py",
        "msmctts_tpu_torch/training/optim.py", "msmctts_tpu_torch/training/base_trainer.py",
        "msmctts_tpu_torch/training/vqgan_trainer.py", "chip_smoke.py",
        "msmctts_tpu_torch/parallel/__init__.py", "msmctts_tpu_torch/parallel/mesh.py",
        "msmctts_tpu_torch/parallel/launch.py", "msmctts_tpu_torch/train_dist.py",
        "msmctts_tpu_torch/training/predictor_trainer.py", "msmctts_tpu_torch/models/quantizer.py",
        "msmctts_tpu_torch/utils/checkpoint.py", "msmctts_tpu_torch/streaming.py",
        "msmctts_tpu_torch/serving.py", "msmctts_tpu_torch/serve.py", "msmctts_tpu_torch/infer.py",
        "msmctts_tpu_torch/utils/plot.py", "msmctts_tpu_torch/models/tdnn.py",
        "msmctts_tpu_torch/models/msmc_vqgan_emb.py", "msmctts_tpu_torch/training/emb_vqgan_trainer.py",
        "msmctts_tpu_torch/ops/int8_generator.py",
    ):
        assert rel in scanned, rel


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_port_module_imports_without_the_jax_package():
    modules = [
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in sorted(PORT.rglob("*.py"))
    ]
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in modules]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'msmctts_tpu' or k.startswith('msmctts_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(" + repr(modules) + "))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
    assert "msmctts_tpu_torch.training.vqgan_trainer" in modules and "msmctts_tpu_torch.train" in modules
    assert "msmctts_tpu_torch.parallel.mesh" in modules and "msmctts_tpu_torch.train_dist" in modules
    for m in ("streaming", "serving", "serve", "infer", "utils.plot"):
        assert f"msmctts_tpu_torch.{m}" in modules


def test_entry_points_refuse_cpu_fallback(monkeypatch, tmp_path):
    from msmctts_tpu_torch import synthesize, train
    from msmctts_tpu_torch.config import Config
    from msmctts_tpu_torch.tasks import build_task
    from msmctts_tpu_torch.utils.checkpoint import save_checkpoint
    from msmctts_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")

    cfg = Config({"task": {"_name": "MSMCTTS"}, "dataset": {"samplerate": 16000}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_task(cfg)
    assert build_task(cfg, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_task(cfg, mode="train")
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text("task: {_name: MSMCTTS}\ndataset: {samplerate: 16000}\ntrainer: {_name: VQGANTrainer}\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["-c", str(cfg_path), "--max-steps", "1"])

    ckpt = str(tmp_path / "m.ckpt")
    save_checkpoint(ckpt, {"params": {}}, 0, cfg.to_dict())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthesize.main(["-m", ckpt, "--text", "1_0_0", "-o", str(tmp_path / "o.wav")])


def test_kernel_wrappers_take_the_plain_version_only_on_cpu():
    from msmctts_tpu_torch.ops import resblock, vq

    x = torch.zeros(4, 2, 3)
    e = torch.zeros(2, 3, 5)
    vq.KERNEL.launches = 0
    vq.vq_nearest(x, e)
    assert vq.KERNEL.launches == 0  # the CPU path never counts a launch
    with pytest.raises(ValueError, match="unsupported device"):
        vq.vq_nearest(x.to("meta"), e.to("meta"))
    w = torch.zeros(3, 4, 4)
    b = torch.zeros(4)
    y = resblock.fused_resblock_layer(torch.zeros(1, 5, 4), w, b, w, b, 1)
    assert y.shape == (1, 5, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        resblock.fused_resblock_layer(torch.zeros(1, 5, 4, device="meta"), w, b, w, b, 1)


def test_tile_choice_fits_every_csmsc_layer():
    from msmctts_tpu_torch.ops.resblock import MAX_SHARED_BYTES, choose_tile, plan_layer, shared_bytes

    for C in (256, 128, 64, 32):
        for k in (3, 7, 11):
            for d in (1, 3, 5):
                tile = choose_tile(C, k, d)
                assert tile % 64 == 0
                assert shared_bytes(C, k, d, tile, plan_layer(C, k, d).stages) <= MAX_SHARED_BYTES
    with pytest.raises(ValueError, match="does not fit"):
        choose_tile(1024, 11, 5)


def test_checkpoint_reader_upcasts_and_checks_format(tmp_path):
    import pickle

    from msmctts_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    path = str(tmp_path / "c.ckpt")
    save_checkpoint(path, {"params": {"a": np.ones(3, np.float16), "i": np.arange(2)}}, 7, {"x": 1})
    ck = load_checkpoint(path)
    assert ck["iteration"] == 7 and ck["config"] == {"x": 1}
    assert ck["state"]["params"]["a"].dtype == np.float32
    assert ck["state"]["params"]["i"].dtype == np.arange(2).dtype
    with open(path, "wb") as f:
        pickle.dump({"format": "other"}, f)
    with pytest.raises(ValueError, match="format"):
        load_checkpoint(path)
    with pytest.raises(NotImplementedError, match="orbax"):
        load_checkpoint(str(tmp_path))
