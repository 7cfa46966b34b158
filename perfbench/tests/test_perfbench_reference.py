"""The plain reference against the program on the CPU, at a tiny size of the
CSMSC recipe's shape, on the benchmark's seeded weights.

- one ``predict`` batch: durations, each stage's codeword indices, frame
  totals and waveforms of the reference's own choices equal the program's;
- the served run at the tiny size is judged correct, the TF32 control is not
  (the control of the cell, kept at a size a test run holds);
- the run with the timed path broken underneath is judged not correct, once
  for each fault a served TTS cell can have.
"""

import time

import numpy as np
import pytest
import torch

from conftest import LIMITS
from perfbench import core, traffic, weights
from perfbench.reference.judge_tts import judge
from perfbench.reference.tts import Reference


def _cell(config, mix, seed=2**31 + 77, seconds=1.0):
    return core.Cell(name="csmsc_tts.serve_b16_c32", workload={"chips": 1, "limits": LIMITS}, mix=mix, config=config,
                     seed=seed, seconds=seconds, trace=False, device=torch.device("cpu"), t_start=time.perf_counter())


def test_reference_predict_matches_program(tiny):
    config, mix = tiny
    task, spec = core.driver("serve_closed_loop").build(_cell(config, mix))
    task.pre_infer()
    task.frame_margin = task.padding_reach_frames()
    tr = dict(mix, n_symbols=config["program"]["task"]["predictor"]["n_symbols"])
    texts = traffic.texts(5, tr, 3)
    Lt = mix["engine"]["text_length"]
    batch = {"text": np.zeros((3, Lt, 3), np.int32), "text_length": np.array([len(t) for t in texts])}
    for i, t in enumerate(texts):
        batch["text"][i, : len(t)] = t
    captured = {}
    task.networks["predictor"].register_forward_hook(lambda m, a, o: captured.update(feat=o["feat"]))
    got = task.predict(batch)
    frames = captured["feat"][-1].shape[1]

    W = weights.make(spec, config["weight_seed"], "cpu", config["overrides"])
    ref = Reference(W, config["program"]["task"])
    want = ref.forward(torch.as_tensor(batch["text"]).long(), torch.as_tensor(batch["text_length"]), frames,
                       mix["engine"]["max_frames"])
    own = torch.round(torch.clamp(want["dur"], min=0.0)) * (torch.arange(Lt)[None] < want["dur"].new_tensor(
        batch["text_length"])[:, None])
    np.testing.assert_array_equal(got["duration"], own.numpy())
    np.testing.assert_array_equal(got["mel_length"], want["total"].numpy())
    for j, feat in enumerate(captured["feat"]):
        idx = torch.argmin(ref.distances(feat.float(), j)[0], dim=-1)
        assert torch.equal(idx, want["stages"][j]["idx"]), f"stage {j} indices differ"
        assert torch.equal(feat, ref.lookup(idx, j)), f"stage {j} served values are not its codewords"
    for w_got, w_want in zip(got["wav"], want["wav"]):
        assert w_got.shape == tuple(w_want.shape)
        assert float(np.abs(w_got - w_want.numpy()).max()) < 1e-5
        assert float(np.abs(w_got).max()) > 0.1  # an audible waveform: the difference means something


def test_served_run_is_correct_and_the_control_is_not(tiny):
    config, mix = tiny
    out = core.driver("serve_closed_loop").run(_cell(config, mix))
    assert all(v <= lim for v, lim in out["checks"].values()), out["checks"]
    assert out["checks"]["missing"][0] == 0
    j = out["judged"]
    control = judge(j["W"], config["program"]["task"], mix["engine"], j["texts"], j["served"], j["durs"],
                    control=True)
    failed = {k: v for k, v in control.items() if v > LIMITS[k]}
    assert failed, f"the TF32 control passed every limit: {control}"
    assert control["wav_err"] > 10 * LIMITS["wav_err"]


def _perturb_wav(monkeypatch):
    from msmctts_tpu_torch.tasks import MSMCTTS

    orig = MSMCTTS.predict

    def predict(self, batch):
        out = orig(self, batch)
        out["wav"] = [w + 1e-3 for w in out["wav"]]
        return out

    monkeypatch.setattr(MSMCTTS, "predict", predict)


def _shift_durations(monkeypatch):
    from msmctts_tpu_torch.models.predictor import MultiStagePredictor

    orig = MultiStagePredictor.predict_durations
    monkeypatch.setattr(MultiStagePredictor, "predict_durations", lambda self, t, n: orig(self, t, n) + 1.0)


def _next_codeword(monkeypatch):
    from msmctts_tpu_torch.models import predictor

    orig = predictor.snap_with_codebook

    def snap(x, embed):
        q = orig(x, embed)  # the nearest codewords [B, T, H * d]
        B, T, _ = q.shape
        H, d, K = embed.shape
        e = embed.transpose(1, 2)  # [H, K, d]
        idx = (q.reshape(B * T, H, 1, d) == e[None]).all(-1).float().argmax(-1)  # [B * T, H]
        return e[torch.arange(H)[None], (idx + 1) % K].reshape(B, T, H * d).to(x.dtype)

    monkeypatch.setattr(predictor, "snap_with_codebook", snap)


def _half_batch(monkeypatch):
    from msmctts_tpu_torch.tasks import MSMCTTS

    orig = MSMCTTS.predict

    def predict(self, batch):
        out = orig(self, batch)
        half = len(out["wav"]) // 2
        for key in ("wav", "embedding"):
            out[key] = list(out[key][:half]) * 2 + list(out[key][: len(out[key]) - 2 * half])
        for key in ("duration", "mel_length"):
            out[key] = np.concatenate([out[key][:half]] * 2 + [out[key][: len(out[key]) - 2 * half]])
        return out

    monkeypatch.setattr(MSMCTTS, "predict", predict)


def _stale(monkeypatch):
    from msmctts_tpu_torch.tasks import MSMCTTS

    orig, last = MSMCTTS.predict, {}

    def predict(self, batch):
        out = orig(self, batch)
        prev = last.get("out")
        last["out"] = out
        return prev if prev is not None and len(prev["wav"]) == len(out["wav"]) else out

    monkeypatch.setattr(MSMCTTS, "predict", predict)


def _late_answers_altered(monkeypatch):
    """Every answer altered from the run's 30th request on, past the first
    requests of the window."""
    from msmctts_tpu_torch.serving import BatchingEngine
    from msmctts_tpu_torch.tasks import MSMCTTS

    sent = {"n": 0}
    synthesize, predict = BatchingEngine.synthesize, MSMCTTS.predict

    def counted(self, *args, **kwargs):
        sent["n"] += 1
        return synthesize(self, *args, **kwargs)

    def late(self, batch):
        out = predict(self, batch)
        if sent["n"] > 30:
            out["wav"] = [w + 1e-3 for w in out["wav"]]
        return out

    monkeypatch.setattr(BatchingEngine, "synthesize", counted)
    monkeypatch.setattr(MSMCTTS, "predict", late)


FAULTS = {
    "answer_altered": _perturb_wav,
    "late_answers_altered": _late_answers_altered,
    "durations_altered": _shift_durations,
    "codeword_altered": _next_codeword,
    "half_the_batch_left_out": _half_batch,
    "stale_answers": _stale,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(tiny, monkeypatch, fault):
    """The whole run, past the look for a card, with one fault planted in the
    program: ``correct`` comes out false. (One card: no exchange between
    chips to leave out.)"""
    config, mix = tiny
    FAULTS[fault](monkeypatch)
    result = core.run_cell(_cell(config, mix, seconds=2.0), core.bench())
    assert result["correct"] is False, result["checks"]


# ------------------------------------------------------------------ training
def _train_cell(config, mix, seed=2**31 + 3):
    from conftest import TRAIN_LIMITS

    return core.Cell(name="csmsc_ae.gan_step_b16", workload={"chips": 1, "limits": TRAIN_LIMITS}, mix=mix,
                     config=config, seed=seed, seconds=0.5, trace=False, device=torch.device("cpu"),
                     t_start=time.perf_counter())


def test_train_reference_follows_the_program(tiny_train):
    """Three GAN steps of the tiny recipe with dropout on, run twice (in
    set-up, and from the restored known state after the window): the
    program's losses, first gradients and changes against the plain
    reference's; the TF32 control, half of each batch left out and a
    reference without dropout read far above the limits."""
    from conftest import TRAIN_LIMITS
    from perfbench.reference import judge_train
    from perfbench.reference.tts import Reference

    config, mix = tiny_train
    out = core.driver("train_step").run(_train_cell(config, mix))
    readings = {k: v for k, (v, _) in out["checks"].items()}
    assert readings["loss_gap"] < 1e-6 and readings["grad_gap"] < 1e-5 and readings["change_gap"] < 1e-3, readings
    j = out["judged"]
    ref = judge_train.follow(j["spec"], config, torch.device("cpu"), j["checked"])
    assert len(j["program"]) == 2
    for side in j["program"]:
        assert set(side["first_grad"]) == set(ref["first_grad"])
        assert judge_train.compare(side, ref)["loss_gap"] < 1e-6
    control = judge_train.compare(
        judge_train.follow(j["spec"], config, torch.device("cpu"), j["checked"], precision="tf32"), ref)
    half = judge_train.compare(
        judge_train.follow(j["spec"], config, torch.device("cpu"), j["checked"], rows=mix["batch_size"] // 2), ref)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Reference, "_drop", lambda self, x, rate: x)
        no_dropout = judge_train.compare(judge_train.follow(j["spec"], config, torch.device("cpu"), j["checked"]), ref)
    for side in (control, half, no_dropout):
        assert any(side[k] > 10 * TRAIN_LIMITS[k] for k in side), side


def test_change_gap_leaves_out_elements_moved_by_round_off():
    """An element whose reference gradient is round-off takes Adam's full
    step of either sign, and its change after three steps may differ
    threefold: that element is not counted, any other is."""
    from perfbench.reference.judge_train import compare, norms

    grad = {"a": torch.tensor([1e-2, -3e-3, 2e-8, 5e-3]), "b": torch.tensor([4e-3, -1e-2])}
    change = {"a": torch.tensor([-2e-4, 2e-4, 2e-4, -2e-4]), "b": torch.tensor([-2e-4, 2e-4])}
    ref = {"losses": [{"g_loss": 1.0}], "first_grad": norms(grad), "grad": grad, "change": change}
    side = dict(ref, change={"a": torch.tensor([-2e-4, 2e-4, 6e-4, -2e-4]), "b": change["b"]})
    assert compare(side, ref)["change_gap"] == 0.0
    counted = dict(ref, grad=dict(grad, a=torch.tensor([1e-2, -3e-3, 2e-3, 5e-3])))
    assert compare(side, counted)["change_gap"] > 0.1
    side = dict(ref, change={"a": torch.tensor([-2e-4, 0.0, 2e-4, -2e-4]), "b": change["b"]})
    assert compare(side, ref)["change_gap"] > 0.1


def _frozen_state(monkeypatch):
    from msmctts_tpu_torch.training import optim

    monkeypatch.setattr(optim.Optimizer, "step", lambda self: None)


def _half_rows(monkeypatch):
    from msmctts_tpu_torch.training.vqgan_trainer import VQGANTrainer

    orig = VQGANTrainer.train_step

    def train_step(self, batch, iteration, starts=None):
        half = batch["mel"].shape[0] // 2
        return orig(self, {k: v[:half] for k, v in batch.items()}, iteration,
                    None if starts is None else starts[:half])

    monkeypatch.setattr(VQGANTrainer, "train_step", train_step)


def _frozen_after_setup(monkeypatch):
    """The optimizers update in the set-up's checked steps and never again,
    as a step captured after its warm-up and replayed stale would."""
    from conftest import TINY_TRAIN_MIX
    from msmctts_tpu_torch.training import optim

    orig, calls = optim.Optimizer.step, {"n": 0}

    def step(self):
        calls["n"] += 1
        return orig(self) if calls["n"] <= 2 * TINY_TRAIN_MIX["checked_steps"] else None

    monkeypatch.setattr(optim.Optimizer, "step", step)


TRAIN_FAULTS = {"state_unchanged": _frozen_state, "state_unchanged_after_setup": _frozen_after_setup,
                "half_the_batch_left_out": _half_rows}


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_broken_train_step_is_not_correct(tiny_train, monkeypatch, fault):
    """The whole train run, past the look for a card, with one fault planted
    in the program: ``correct`` comes out false. (One card: no exchange
    between chips to leave out.)"""
    config, mix = tiny_train
    TRAIN_FAULTS[fault](monkeypatch)
    result = core.run_cell(_train_cell(config, mix), core.bench())
    assert result["correct"] is False, result["checks"]
