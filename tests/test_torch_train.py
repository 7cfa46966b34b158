"""The parts of the port's train step against the JAX package on the CPU,
at tiny widths, in fp32 (JAX side under matmul precision "highest"), inputs
from a numpy seed: the masked-statistics VQ's plain version against the
Pallas kernel in interpret mode, the EMA quantizer's training forward and
update, STFT / mel / filterbanks, every discriminator family (scores and
every feature map), every loss, the LR schedule and the optimizer step.

Tolerances. Index and count comparisons are exact. Values that are one or
two fp32 ops away from equal inputs are held to 1e-6; sums over a few
hundred fp32 terms taken in another order (statistics, STFT frames, conv
stacks, loss means) to 1e-5 relative plus 1e-5 absolute, or 1e-4 where a
log or a division by a small norm amplifies the last bit; each is stated at
its assert.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msmctts_tpu.models import hifigan as j_hifigan
from msmctts_tpu.models.quantizer import EMAQuantizer as JEMAQuantizer
from msmctts_tpu.ops import stft as j_stft
from msmctts_tpu.ops.pallas_vq import vq_nearest_stats as j_vq_nearest_stats
from msmctts_tpu.training import losses as j_losses
from msmctts_tpu.training import optim as j_optim
from msmctts_tpu_torch import weights as W
from msmctts_tpu_torch.models import hifigan as t_hifigan
from msmctts_tpu_torch.models.quantizer import EMAQuantizer as TEMAQuantizer
from msmctts_tpu_torch.ops import stft as t_stft
from msmctts_tpu_torch.ops import vq as t_vq
from msmctts_tpu_torch.training import losses as t_losses
from msmctts_tpu_torch.training import optim as t_optim

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, tol=1e-5, atol=None):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got),
        np.asarray(want), rtol=tol, atol=tol if atol is None else atol,
    )


# ------------------------------------------------ kernel 3's plain version


def _stats_inputs(rng, N, H, d, K, mask_kind, tie=False):
    x = rng.normal(size=(N, H, d)).astype(np.float32)
    embed = rng.normal(size=(H, d, K)).astype(np.float32)
    if tie:  # codewords 1 and 3 equal, a third of the rows exactly on them
        embed[:, :, 3] = embed[:, :, 1]
        x[::3] = embed[:, :, 1][None]
    if mask_kind == "ones":
        mask = np.ones(N, np.float32)
    elif mask_kind == "partial":
        mask = (rng.random(N) > 0.3).astype(np.float32)
    else:  # a whole Pallas row tile (256 rows) and a whole CUDA tile (64) invalid
        mask = np.ones(N, np.float32)
        mask[:256] = 0.0
        mask[-70:] = 0.0
    return x, embed, mask


@pytest.mark.parametrize(
    "N,H,d,K,mask_kind,tie",
    [(300, 2, 16, 32, "partial", False), (1600, 4, 64, 64, "partial", False), (512, 2, 8, 16, "ones", False),
     (700, 2, 8, 16, "tiles", False), (1, 2, 8, 16, "ones", False), (96, 2, 8, 16, "partial", True)],
    ids=["ragged", "csmsc-coarse-stage", "tile-multiple", "masked-tiles", "one-row", "exact-tie"],
)
def test_vq_stats_plain_matches_pallas_interpret(rng, N, H, d, K, mask_kind, tie):
    x, embed, mask = _stats_inputs(rng, N, H, d, K, mask_kind, tie)
    idx, quant, counts, sums = t_vq.vq_nearest_stats(_t(x), _t(embed), _t(mask))
    j_idx, j_quant, j_counts, j_sums = j_vq_nearest_stats(
        jnp.asarray(x), jnp.asarray(embed), jnp.asarray(mask), interpret=True
    )
    assert idx.dtype == torch.int32 and counts.shape == (H, K) and sums.shape == (H, d, K)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))  # small integers in fp32
    assert float(counts.sum()) == float(mask.sum()) * H
    _close(quant, j_quant, 0, atol=1e-6)  # a gather here, a one-hot product there
    _close(sums, j_sums, 1e-5, atol=1e-4)  # up to N terms of size ~1, another order
    # the snap half is the snap kernel's function, bit for bit
    s_idx, s_quant = t_vq.vq_nearest(_t(x), _t(embed))
    assert torch.equal(idx, s_idx) and torch.equal(quant, s_quant)
    if tie:
        assert (idx.numpy()[::3] == 1).all()


def test_vq_stats_wrapper_checks_and_counts():
    x, e, m = torch.zeros(4, 2, 3), torch.zeros(2, 3, 5), torch.ones(4)
    t_vq.STATS_KERNEL.launches = 0
    idx, quant, counts, sums = t_vq.vq_nearest_stats(x, e, m)
    assert t_vq.STATS_KERNEL.launches == 0  # the CPU path never counts a launch
    assert counts[:, 0].tolist() == [4.0, 4.0] and float(sums.abs().sum()) == 0.0
    with pytest.raises(ValueError, match="unsupported device"):
        t_vq.vq_nearest_stats(x.to("meta"), e.to("meta"), m.to("meta"))
    # the reduction's shape depends on N alone
    assert [t_vq.stats_walkers(n) for n in (1, 64, 65, 1600, 6400)] == [1, 1, 2, 25, 32]
    assert t_vq.stats_shared_bytes(64, 64) <= t_vq.MAX_SHARED_BYTES


# ------------------------------------------------------- EMA quantizer


def _quantizer_pair(rng, use_pallas):
    D, K, H = 16, 8, 2
    jq = JEMAQuantizer(embed_dim=D, n_embed=K, n_head=H, use_pallas=use_pallas)
    codebook = {
        "embed": rng.normal(size=(H, D // H, K)).astype(np.float32),
        "cluster_size": rng.uniform(0.5, 4.0, size=(H, K)).astype(np.float32),
        "embed_avg": rng.normal(size=(H, D // H, K)).astype(np.float32),
    }
    tq = TEMAQuantizer(D, K, n_head=H)
    W.load_numpy_state(tq, W.quantize_from_jax(codebook))
    return jq, codebook, tq


@pytest.mark.parametrize("use_pallas", [False, True], ids=["unfused", "pallas-interpret"])
def test_ema_quantizer_training_forward_matches_flax(rng, use_pallas):
    jq, codebook, tq = _quantizer_pair(rng, use_pallas)
    B, T = 3, 12
    lengths = np.array([12, 7, 1], np.int32)
    tq.train()
    for step in range(2):  # the second step starts from the first one's codebook
        x = rng.normal(size=(B, T, 16)).astype(np.float32)
        with jax.default_matmul_precision("highest"):
            (jst, jdiff, jidx), mut = jq.apply({"codebook": codebook}, x, lengths=lengths, mutable=["codebook"])
        old_embed = tq.embed.clone()
        tx = _t(x).requires_grad_(True)
        st, diff, idx = tq(tx, lengths=_t(lengths).long())
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        _close(st, jst, 1e-6)
        _close(diff, jdiff, 1e-6)
        # the codewords returned are the old codebook's
        from msmctts_tpu_torch.models.quantizer import lookup_codes

        old = lookup_codes(idx, old_embed).reshape(B, T, 16)
        _close(diff, torch.square(old - tx.detach()), 1e-6)
        new = mut["codebook"]
        for key in ("cluster_size", "embed_avg", "embed"):
            # one EMA step from equal state: a few fp32 ops on sums of <= 20 terms
            _close(getattr(tq, key), new[key], 1e-5, atol=1e-6)
        assert not np.allclose(np.asarray(new["embed"]), codebook["embed"])
        # straight-through: d(sum(st) + sum(diff))/dx = 1 + 2 (x - quant)
        (st.sum() + diff.sum()).backward()
        _close(tx.grad, 1.0 + 2.0 * (tx.detach() - old), 1e-5)
        codebook = jax.tree_util.tree_map(np.asarray, new)


def test_ema_quantizer_moves_only_in_training_mode_with_update(rng):
    _, codebook, tq = _quantizer_pair(rng, False)
    x = _t(rng.normal(size=(2, 9, 16)).astype(np.float32))
    before = {k: v.clone() for k, v in tq.state_dict().items()}
    tq.eval()
    st_eval, diff_eval, idx_eval = tq(x)
    tq.train()
    st_off, _, idx_off = tq(x, update=False)
    for k, v in tq.state_dict().items():
        assert torch.equal(v, before[k]), k
    st_on, diff_on, idx_on = tq(x)  # all frames valid without lengths
    assert torch.equal(idx_eval, idx_on) and torch.equal(idx_off, idx_on)
    assert torch.equal(st_eval, st_on) and torch.equal(diff_eval, diff_on)
    assert not torch.equal(tq.embed, before["embed"])
    total = tq.cluster_size.sum() - before["cluster_size"].sum() * 0.99
    assert float(total) == pytest.approx(0.01 * 2 * 9 * 2, rel=1e-5)  # (1 - decay) * frames * heads
    with pytest.raises(NotImplementedError):
        tq(x, sort=True)
    with pytest.raises(NotImplementedError):
        TEMAQuantizer(16, 8, n_head=2, restart_dead=0.5)


# ------------------------------------------------------------- STFT, mel


@pytest.mark.parametrize(
    "n_fft,hop,win,center,normalized",
    [(64, 16, 64, True, False), (32, 8, 32, True, True), (64, 16, 48, False, False), (60, 15, 60, True, True)],
    ids=["center", "normalized", "short-window-no-center", "mrd-hop15"],
)
def test_stft_matches_jax(rng, n_fft, hop, win, center, normalized):
    x = rng.normal(size=(3, 200)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        jr, ji = j_stft.stft_real_imag(jnp.asarray(x), n_fft, hop, win, center=center, normalized=normalized)
        jm = j_stft.stft_magnitude(jnp.asarray(x), n_fft, hop, win, center=center, normalized=normalized)
    tr, ti = t_stft.stft_real_imag(_t(x), n_fft, hop, win, center=center, normalized=normalized)
    tm = t_stft.stft_magnitude(_t(x), n_fft, hop, win, center=center, normalized=normalized)
    assert tuple(tr.shape) == tuple(jr.shape) == (3, n_fft // 2 + 1, jr.shape[-1])
    # dot products of n_fft terms of size ~1
    _close(tr, jr, 1e-5, atol=2e-5)
    _close(ti, ji, 1e-5, atol=2e-5)
    _close(tm, jm, 1e-5, atol=2e-5)


def test_stft_agrees_with_torch_stft(rng):
    x = _t(rng.normal(size=(2, 160)).astype(np.float32))
    ref = torch.stft(x, 32, 8, 24, window=torch.hann_window(24), center=True, pad_mode="reflect",
                     normalized=True, return_complex=True)
    tr, ti = t_stft.stft_real_imag(x, 32, 8, 24, center=True, normalized=True)
    _close(tr, ref.real, 1e-5, atol=1e-5)
    _close(ti, ref.imag, 1e-5, atol=1e-5)


def test_mel_spectrogram_and_filterbanks_match_jax(rng):
    x = rng.normal(size=(2, 256)).astype(np.float32) * 0.3
    x[1, 100:] = 0.0  # silence reaches the 1e-5 clamp
    with jax.default_matmul_precision("highest"):
        jm = j_stft.mel_spectrogram_hifigan(jnp.asarray(x), 1600, 64, 16, 64, 8)
    tm = t_stft.mel_spectrogram_hifigan(_t(x), 1600, 64, 16, 64, 8)
    assert tuple(tm.shape) == tuple(jm.shape)
    _close(tm, jm, 1e-4)  # the log amplifies the last bit of small mels
    assert float(tm.min()) == pytest.approx(np.log(1e-5), rel=1e-6)
    np.testing.assert_array_equal(t_stft.hann_window(48), j_stft.hann_window(48))
    np.testing.assert_array_equal(t_stft.mel_filterbank(24000, 1024, 80), j_stft.mel_filterbank(24000, 1024, 80))
    np.testing.assert_array_equal(
        t_stft.mel_filterbank(16000, 512, 40, fmin=50.0, fmax=7000.0, htk=True, norm=None),
        j_stft.mel_filterbank(16000, 512, 40, fmin=50.0, fmax=7000.0, htk=True, norm=None),
    )
    np.testing.assert_array_equal(
        t_stft.mel_filterbank_htk(31, 0.0, 12000.0, 31, 24000), j_stft.mel_filterbank_htk(31, 0.0, 12000.0, 31, 24000)
    )


# ------------------------------------------------------- discriminators

MRD_CFG = {"hop_lengths": [4, 8], "hidden_channels": [32, 32], "domain": "double", "mel_scale": True, "sample_rate": 1600}
MPD_CFG = {"periods": [2, 3], "channels": 4, "max_channels": 16}


def _flax_params(module, *inputs):
    return jax.device_get(jax.jit(lambda k: module.init(k, *inputs))(jax.random.PRNGKey(0)))["params"]


def _assert_disc_outputs(t_out, j_out, tol):
    (ts, tf), (js, jf) = t_out, j_out
    assert len(ts) == len(js) and len(tf) == len(jf)
    for a, b in zip(ts, js):
        b = np.asarray(b)
        a = a.detach().numpy()
        if a.ndim == 4:  # [B, 1, H, W] here, [B, H, W, 1] there
            a = a.transpose(0, 2, 3, 1)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    for fa, fb in zip(tf, jf):
        assert len(fa) == len(fb)
        for a, b in zip(fa, fb):
            a = a.detach().numpy().transpose(0, 2, 3, 1)
            assert a.shape == np.asarray(b).shape
            np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize(
    "family",
    ["DiscriminatorR", "MRD-double", "MRD-single-linear", "MRD-resolutions", "DiscriminatorP", "MPD", "UnivNet"],
)
def test_discriminator_matches_flax(rng, family):
    """Scores and every feature map; conv stacks of up to 7 layers, 1e-4."""
    wav = (rng.normal(size=(2, 97)) * 0.3).astype(np.float32)  # 97: not a multiple of any period
    if family == "DiscriminatorR":
        img = rng.normal(size=(2, 9, 13, 2)).astype(np.float32)
        jm, tm = j_hifigan.DiscriminatorR(32), t_hifigan.DiscriminatorR(32)
        params = _flax_params(jm, img)
        W.load_numpy_state(tm, W.discriminator_r_from_jax(params))
        j_out = jm.apply({"params": params}, img)
        t_score, t_fmaps = tm(_t(img.transpose(0, 3, 1, 2)))
        assert len(t_fmaps) == 6  # post-activation maps; the last conv is left out
        assert all(float((f.detach() < 0).float().mean()) > 0.05 for f in t_fmaps)
        _assert_disc_outputs(([t_score], [t_fmaps]), ([j_out[0]], [j_out[1]]), 1e-4)
        back = W.discriminator_r_to_jax(W.state_dict_numpy(tm))
        jax.tree_util.tree_map(np.testing.assert_array_equal, back, jax.tree_util.tree_map(np.asarray, params))
        return
    if family.startswith("MRD"):
        cfg = dict(MRD_CFG)
        if family == "MRD-single-linear":
            cfg.update(domain="linear", mel_scale=False)
        if family == "MRD-resolutions":
            cfg = {"resolutions": [[32, 8, 24], [16, 4, 16]], "channels": 32, "sample_rate": 1600}
        jm, tm = j_hifigan.MultiResolutionDiscriminator(**cfg), t_hifigan.MultiResolutionDiscriminator(**cfg)
        params = _flax_params(jm, wav)
        sd = {}
        for name, p in params.items():
            sd.update(W.discriminator_r_from_jax(p, f"discriminators.{int(name.split('_')[-1])}"))
    elif family == "DiscriminatorP":
        jm, tm = j_hifigan.DiscriminatorP(3, 4, 16), t_hifigan.DiscriminatorP(3, 4, 16)
        params = _flax_params(jm, wav)
        sd = W.discriminator_p_from_jax(params)
    elif family == "MPD":
        jm, tm = j_hifigan.MultiPeriodDiscriminator(**MPD_CFG), t_hifigan.MultiPeriodDiscriminator(**MPD_CFG)
        params = _flax_params(jm, wav)
        sd = {}
        for i, p in enumerate(MPD_CFG["periods"]):
            sd.update(W.discriminator_p_from_jax(params[f"disc_p{p}"], f"discriminators.{i}"))
    else:
        jm = j_hifigan.UnivNetDiscriminator(MRD_CFG, MPD_CFG)
        tm = t_hifigan.UnivNetDiscriminator(MRD_CFG, MPD_CFG)
        params = _flax_params(jm, wav)
        sd = W.univnet_discriminator_from_jax(params, periods=MPD_CFG["periods"])
        back = W.univnet_discriminator_to_jax(sd, periods=MPD_CFG["periods"])
        jax.tree_util.tree_map(np.testing.assert_array_equal, back, jax.tree_util.tree_map(np.asarray, params))
    W.load_numpy_state(tm, sd)
    with jax.default_matmul_precision("highest"):
        j_out = jm.apply({"params": params}, wav)
    for training in (True, False):  # live weight norm and the folded copy give the same function
        tm.train(training)
        t_out = tm(_t(wav))
        if family == "DiscriminatorP":
            t_out, j_out_ = ([t_out[0]], [t_out[1]]), ([j_out[0]], [j_out[1]])
        else:
            j_out_ = j_out
        _assert_disc_outputs(t_out, j_out_, 1e-4)
    if family == "UnivNet":  # [B, T, 1] input too
        t3 = tm(_t(wav)[..., None])
        assert all(torch.equal(a, b) for a, b in zip(t3[0], t_out[0]))


# --------------------------------------------------------------- losses


def test_quantizer_frame_and_duration_losses_match_jax(rng):
    lengths = [np.array([5, 9], np.int32), np.array([10, 18], np.int32)]
    diffs = [rng.random(size=(2, 10, 6)).astype(np.float32), rng.random(size=(2, 20, 6)).astype(np.float32)]
    prior = {"total_loss": np.float32(0.7), "embed_loss_mse_1": np.float32(0.7)}
    jv, jm = j_losses.quantizer_loss([jnp.asarray(d) for d in diffs], lengths, prior, lambda_vq=0.5, lambda_pr=0.1)
    tv, tm = t_losses.quantizer_loss(
        [_t(d) for d in diffs], [_t(l) for l in lengths], {k: torch.tensor(v) for k, v in prior.items()},
        lambda_vq=0.5, lambda_pr=0.1,
    )
    _close(tv, jv)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        _close(tm[k], jm[k])
    jv0, _ = j_losses.quantizer_loss([jnp.asarray(diffs[0])], lengths[:1], None)
    tv0, _ = t_losses.quantizer_loss([_t(diffs[0])], [_t(lengths[0])], None)
    _close(tv0, jv0)

    pred, tgt = rng.normal(size=(2, 20, 8)).astype(np.float32), rng.normal(size=(2, 20, 8)).astype(np.float32)
    _close(t_losses.frame_loss(_t(pred), _t(tgt), _t(lengths[1])), j_losses.frame_loss(pred, tgt, lengths[1]))
    dp, dt = rng.normal(size=(2, 10)).astype(np.float32), rng.normal(size=(2, 10)).astype(np.float32)
    _close(t_losses.duration_loss(_t(dp), _t(dt), _t(lengths[0])), j_losses.duration_loss(dp, dt, lengths[0]))
    zero = np.zeros(2, np.int32)  # the denominators' floor
    _close(t_losses.frame_loss(_t(pred), _t(tgt), _t(zero)), j_losses.frame_loss(pred, tgt, zero))


def test_spectral_losses_match_jax(rng):
    p = (rng.normal(size=(2, 400)) * 0.2).astype(np.float32)
    t = (rng.normal(size=(2, 400)) * 0.2).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        j_mel = j_losses.mel_loss(p, t, 1600, fft_size=64, hop_size=16, win_size=64, num_mels=8)
        j_mel_default = j_losses.mel_loss(p, t, 1600, fft_size=128)  # win 80, hop 20 from the rate
        j_stft1 = j_losses.stft_loss(p, t, fft_size=64, win_size=48, hop_size=12)
        j_stft_mel = j_losses.stft_loss(p, t, fft_size=64, win_size=48, hop_size=12, mel_scale=True,
                                        sample_rate=1600, num_mels=8)
        j_mr = j_losses.multi_resolution_stft_loss(p, t, fft_sizes=(64, 128, 32), win_sizes=(48, 96, 24),
                                                   hop_sizes=(12, 24, 6))
    # means over thousands of |log| terms, each ~1e-6 off
    _close(t_losses.mel_loss(_t(p), _t(t), 1600, fft_size=64, hop_size=16, win_size=64, num_mels=8), j_mel, 1e-4)
    _close(t_losses.mel_loss(_t(p), _t(t), 1600, fft_size=128), j_mel_default, 1e-4)
    for got, want in (
        (t_losses.stft_loss(_t(p), _t(t), fft_size=64, win_size=48, hop_size=12), j_stft1),
        (t_losses.stft_loss(_t(p), _t(t), fft_size=64, win_size=48, hop_size=12, mel_scale=True,
                            sample_rate=1600, num_mels=8), j_stft_mel),
        (t_losses.multi_resolution_stft_loss(_t(p), _t(t), fft_sizes=(64, 128, 32), win_sizes=(48, 96, 24),
                                             hop_sizes=(12, 24, 6)), j_mr),
    ):
        assert sorted(got) == ["mag_loss", "sc_loss"]
        _close(got["sc_loss"], want["sc_loss"], 1e-4)
        _close(got["mag_loss"], want["mag_loss"], 1e-4)


def test_gan_losses_match_jax(rng):
    shapes = [(2, 5), (2, 3, 4, 1), (2, 7)]
    real = [rng.normal(size=s).astype(np.float32) for s in shapes]
    fake = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jr, jf = j_losses.lsgan_d_loss(real, fake)
    tr, tf = t_losses.lsgan_d_loss([_t(x) for x in real], [_t(x) for x in fake])
    _close(tr, jr)
    _close(tf, jf)
    _close(t_losses.lsgan_g_loss([_t(x) for x in fake]), j_losses.lsgan_g_loss(fake))
    ff = [[rng.normal(size=(2, 3, 4, 5)).astype(np.float32) for _ in range(3)] for _ in range(2)]
    rf = [[rng.normal(size=(2, 3, 4, 5)).astype(np.float32) for _ in range(3)] for _ in range(2)]
    _close(
        t_losses.feature_matching_loss([[_t(x) for x in f] for f in ff], [[_t(x) for x in f] for f in rf]),
        j_losses.feature_matching_loss(ff, rf),
    )


def test_paired_disc_apply_is_two_separate_calls(rng):
    calls = []

    class Probe(torch.nn.Module):
        def forward(self, wav):
            calls.append(tuple(wav.shape))
            return [wav.mean(dim=1)], [[wav[:, None, None]]]

    fake, real = torch.zeros(3, 10), torch.ones(3, 10)
    fs, ff, rs, rf = t_losses.paired_disc_apply(Probe(), fake, real)
    assert calls == [(3, 10), (3, 10)]  # never one concatenated batch of 6
    assert float(fs[0].sum()) == 0.0 and float(rs[0].sum()) == 3.0
    assert float(ff[0][0].sum()) == 0.0 and float(rf[0][0].sum()) == 30.0


# ------------------------------------------------------------ optimizers

LR_CFG = {"_name": "ExponentialDecayLRScheduler", "warmup_steps": 3, "decay_scale": 4,
          "decay_learning_rate": 0.5, "final_learning_rate": 1e-5}


def test_lr_schedule_matches_jax():
    js, ts = j_optim.make_lr_schedule(2e-4, LR_CFG), t_optim.make_lr_schedule(2e-4, LR_CFG)
    for step in (0, 1, 2, 3, 4, 7, 11, 40, 1000):
        assert ts(step) == pytest.approx(float(js(step)), rel=1e-6)
    assert ts(0) == 2e-4 and ts(1000) == 1e-5
    assert t_optim.make_lr_schedule(1e-3, None)(50) == 1e-3
    with pytest.raises(ValueError, match="unknown lr scheduler"):
        t_optim.make_lr_schedule(1e-3, {"_name": "Cosine"})
    cfg = {"optimizer": {"_default": {"_name": "AdamW"}, "discriminator": {"_name": "Adam"}}}
    assert t_optim.optimizer_config_for(cfg, "autoencoder") == j_optim.optimizer_config_for(cfg, "autoencoder")
    assert t_optim.optimizer_config_for(cfg, "discriminator") == {"_name": "Adam"}
    assert t_optim.optimizer_config_for({}, "x") == j_optim.optimizer_config_for({}, "x")


def _param_tree(rng):
    return {
        "enc": {"w": rng.normal(size=(4, 3)).astype(np.float32), "b": rng.normal(size=(3,)).astype(np.float32)},
        "dec": {"w": rng.normal(size=(3, 5)).astype(np.float32)},
    }


@pytest.mark.parametrize(
    "opt_cfg,clip,freeze,tol",
    [
        ({"_name": "AdamW", "learning_rate": 2e-4, "betas": [0.8, 0.99], "eps": 1e-8, "weight_decay": 0.0}, 1.0, None, 1e-6),
        ({"_name": "AdamW", "learning_rate": 1e-2, "betas": [0.9, 0.999], "weight_decay": 0.1}, 0.05, None, 1e-6),
        ({"_name": "Adam", "learning_rate": 1e-2, "betas": [0.9, 0.98], "eps": 1e-9, "weight_decay": 0.05}, None, None, 1e-6),
        ({"_name": "RAdam", "learning_rate": 1e-2}, 100.0, None, 1e-5),
        ({"_name": "AdamW", "learning_rate": 1e-2, "weight_decay": 0.1}, 0.05, ["^enc/"], 1e-6),
    ],
    ids=["recipe-adamw", "adamw-decay-clipped", "adam-l2", "radam-clip-idle", "frozen-encoder"],
)
def test_optimizer_steps_match_optax(rng, opt_cfg, clip, freeze, tol):
    """Eight steps from equal parameters and equal gradients. Parameters
    within 1e-6: each step is a handful of fp32 ops at a rate <= 1e-2. RAdam
    gets 1e-5: optax evaluates its rectification term in fp32, where
    rho_inf - 2 t b2^t / (1 - b2^t) cancels (1999 - 1993 at t = 6) and keeps
    about three digits, so steps of 1e-2 agree to a few 1e-6."""
    tree = _param_tree(rng)
    tx = j_optim.build_optimizer(opt_cfg, LR_CFG, clip, freeze_patterns=freeze)
    j_params = jax.tree_util.tree_map(jnp.asarray, tree)
    j_state = tx.init(j_params)
    named = [(f"{a}.{b}", torch.nn.Parameter(_t(v.copy()))) for a, sub in tree.items() for b, v in sub.items()]
    opt = t_optim.build_optimizer(named, opt_cfg, LR_CFG, clip, freeze_patterns=freeze)
    for step in range(8):
        grads = jax.tree_util.tree_map(lambda v: (rng.normal(size=v.shape) * 0.1).astype(np.float32), tree)
        updates, j_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        opt.zero_grad()
        for name, p in named:
            a, b = name.split(".")
            p.grad = _t(grads[a][b].copy())
        opt.step()
        assert opt.count == step + 1
    for name, p in named:
        a, b = name.split(".")
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_params[a][b]), rtol=tol, atol=tol, err_msg=name)
        moved = not np.array_equal(p.detach().numpy(), tree[a][b])
        assert moved == (not (freeze and a == "enc")), name


def test_clip_follows_optax_not_torch(rng):
    """``clip / max(norm, clip)``: a gradient under the threshold is left
    alone, one over it is scaled to the threshold exactly."""
    p = torch.nn.Parameter(torch.zeros(4))
    opt = t_optim.build_optimizer([("p", p)], {"_name": "Adam", "learning_rate": 1e-3}, None, grad_clip=1.0)
    seen = []
    opt.opt.step = lambda: seen.append(p.grad.clone())
    p.grad = torch.tensor([0.3, 0.0, 0.4, 0.0])
    opt.step()
    p.grad = torch.tensor([3.0, 0.0, 4.0, 0.0])
    opt.step()
    assert torch.equal(seen[0], torch.tensor([0.3, 0.0, 0.4, 0.0]))
    torch.testing.assert_close(seen[1], torch.tensor([0.6, 0.0, 0.8, 0.0]), rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="unknown optimizer"):
        t_optim.build_optimizer([("p", p)], {"_name": "SGD"}, None)
