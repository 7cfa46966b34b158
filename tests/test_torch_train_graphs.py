"""CUDA graphs of the GAN step (``utils/graphs.py``, ``VQGANTrainer``'s
``_graph_binding`` / ``_graphed_gan_step``) on the CPU, at ``tests/tiny.py``
widths.

The CPU has no CUDA graphs, so :class:`RecordedGraph` stands in for one:
capture records every aten operation that runs, with its tensors, and a
replay runs the recorded operations again on the same tensors, writing each
result where the capture's result lies, as a CUDA graph rewrites its memory
(a read back to the host inside a capture raises, as it would on the
card). Unlike a CUDA graph it runs the work while it records it, so the
pass takes its results from the capture itself (``runs_on_capture``). With
it the step's own code captures and replays as on the card: the eligibility
policy, the shape key (eager at a shape's first sight, captured at its
second), the spans, a capture that finds the trainer as the step left it,
steps that equal the eager ones and the benchmark's restore sequence
between replays."""

import copy

import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from msmctts_tpu_torch.config import Config as TConfig
from msmctts_tpu_torch.config import component_kwargs
from msmctts_tpu_torch.ops.dropout import bind_generator
from msmctts_tpu_torch.registry import get_trainer
from msmctts_tpu_torch.tasks import build_task
from msmctts_tpu_torch.utils import graphs, tracing
from tests.tiny import FRAMESHIFT, MEL_DIM, tiny_ae_config

torch.set_num_threads(2)

_READS_BACK = {torch.ops.aten._local_scalar_dense.default, torch.ops.aten.item.default,
               torch.ops.aten.is_nonzero.default, torch.ops.aten.equal.default}


class _Record(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _READS_BACK:
            raise RuntimeError(f"{func} reads a value back to the host inside a capture")
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


def _tensors(tree):
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


class RecordedGraph:
    """A CPU stand-in for ``utils.graphs.CudaGraph`` (see the module docstring)."""

    runs_on_capture = True
    made = 0

    def __init__(self, pool, generator):
        self.ops = []
        RecordedGraph.made += 1

    def begin(self):
        self.mode = _Record(self.ops)
        self.mode.__enter__()

    def end(self):
        self.mode.__exit__(None, None, None)

    def replay(self):
        with torch.no_grad():
            for func, args, kwargs, out in self.ops:
                new = func(*args, **kwargs)
                for o, n in zip(_tensors(out), _tensors(new)):
                    if o.untyped_storage().data_ptr() != n.untyped_storage().data_ptr():
                        o.copy_(n)


@pytest.fixture
def recorded(monkeypatch):
    """Graphs on the CPU, recorded."""
    monkeypatch.setattr(graphs, "available", lambda device: True)
    monkeypatch.setattr(graphs, "CudaGraph", RecordedGraph)
    RecordedGraph.made = 0


@pytest.fixture(autouse=True)
def empty_buffer():
    tracing.clear()
    yield
    tracing.clear()


def _trainer(tmp_path, **trainer):
    cfg = tiny_ae_config(str(tmp_path)).to_dict()
    cfg["trainer"].update(trainer)
    cfg = TConfig(cfg)
    task = build_task(cfg, device="cpu", mode="train")
    tr = get_trainer(cfg.trainer["_name"])(cfg, task, **component_kwargs(cfg.trainer))
    tr.init_state()
    return tr


def _batch(B=4, T=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    lengths = torch.tensor([T, T - 4, T - 12, T - 16][:B])
    mel = torch.randn((B, T, MEL_DIM), generator=g)
    wav = torch.randn((B, T * FRAMESHIFT), generator=g) * 0.1
    starts = torch.randint(0, T - 8, (B,), generator=g)
    return {"mel": mel, "mel_length": lengths, "wav": wav}, starts


def _state(tr):
    """Weights and buffers of both networks, the optimizers' state and the
    generator's, as copies."""
    nets = {f"{n}.{k}": v.detach().clone() for n, net in (("ae", tr.ae), ("disc", tr.disc))
            for k, v in net.state_dict().items()}
    opts = {n: copy.deepcopy(o.state_dict()) for n, o in tr.optimizers.items()}
    return nets, opts, tr.generator.get_state().clone()


def _same_state(a, b):
    (na, oa, ga), (nb, ob, gb) = a, b
    assert na.keys() == nb.keys()
    for k in na:
        assert torch.equal(na[k], nb[k]), k
    assert torch.equal(ga, gb)
    for n in oa:
        assert oa[n]["count"] == ob[n]["count"]
        sa, sb = oa[n]["opt"]["state"], ob[n]["opt"]["state"]
        assert sa.keys() == sb.keys()
        for i in sa:
            for key in sa[i]:
                assert torch.equal(torch.as_tensor(sa[i][key]), torch.as_tensor(sb[i][key])), (n, i, key)


def _run(tr, batches, first_iteration=3):
    out = []
    for i, (batch, starts) in enumerate(batches):
        m = tr.train_step(batch, first_iteration + i, starts=starts)
        out.append({k: v.clone() for k, v in m.items()})
    return out


def _steps_named(name):
    return [s for s in tracing.spans() if s.name == name]


# ------------------------------------------------------------------ policy


class _Group:
    def __init__(self, backend):
        self.backend, self.world, self.rank = backend, 2, 0


def test_policy_eager_on_the_cpu(tmp_path):
    tr = _trainer(tmp_path)
    assert tr._graph_binding() is None
    tr.train_step(*_batch()[:1], 3, starts=_batch()[1])
    (step,) = _steps_named("train.step")
    assert step.attrs["graphed"] == 0 and not _steps_named("train.capture")


def test_policy_by_group_phase_precision_and_hooks(tmp_path, recorded):
    tr = _trainer(tmp_path)
    assert tr._graph_binding() is not None
    batch = _batch()[0]
    for it in (1, 2, 1):  # the warmup phase (warmup_steps 2): eager, at any sight
        tr.train_step(batch, it)
    assert [s.attrs["graphed"] for s in _steps_named("train.step")] == [0, 0, 0] and not tr._graphs
    tr.group = _Group("gloo")
    assert tr._graph_binding() is None
    tr.group = _Group("nccl")
    assert tr._graph_binding() is not None
    tr.group = None
    tr.tp = object()  # a model group: split convs run collectives inside the forward
    assert tr._graph_binding() is None
    tr.tp = None
    tr.compute_dtype = torch.bfloat16
    assert tr._graph_binding() is None
    tr.compute_dtype = torch.float32
    top = tr.ae.register_forward_hook(lambda m, a, o: None)  # around the call: still graphed
    assert tr._graph_binding() is not None
    inner = tr.ae.decoder.register_forward_hook(lambda m, a, o: None)  # inside the forward: eager
    assert tr._graph_binding() is None
    inner.remove()
    top.remove()
    assert tr._graph_binding() is not None


# ------------------------------------------------------------- key, spans


def test_a_shape_runs_eager_then_is_captured_once_then_replayed(tmp_path, recorded):
    tr = _trainer(tmp_path)
    small, small_starts = _batch(T=32)
    large, large_starts = _batch(T=48, seed=1)
    order = [(small, small_starts)] * 2 + [(large, large_starts)] * 2 + [(small, small_starts)]
    for it, (batch, starts) in enumerate(order, start=3):
        tr.train_step(batch, it, starts=starts)
    steps = _steps_named("train.step")
    assert [s.attrs["graphed"] for s in steps] == [0, 1, 0, 1, 1]
    captures = _steps_named("train.capture")
    window = tr.frame_lengths
    assert [(c.attrs["rows"], c.attrs["frames"], c.attrs["window"]) for c in captures] == [(4, 32, window),
                                                                                         (4, 48, window)]
    by_id = {s.id: s for s in steps}
    assert [by_id[c.parent].attrs["iteration"] for c in captures] == [4, 6]
    assert list(tr._graphs) == [(4, 48, window), (4, 32, window)]  # the most recently used last
    # the step's phases lie inside the capture when it captures, directly under the step otherwise
    phases = {s.parent for s in tracing.spans() if s.name == "train.ae_forward"}
    assert {c.id for c in captures} <= phases and {steps[0].id, steps[4].id} <= phases
    made = RecordedGraph.made
    tr.train_step(small, 8, starts=small_starts)
    assert RecordedGraph.made == made  # a replay makes no graph


def test_a_new_dropout_binding_captures_again(tmp_path, recorded):
    tr = _trainer(tmp_path)
    batch, starts = _batch()
    for it in (3, 4, 5):
        tr.train_step(batch, it, starts=starts)
    assert len(_steps_named("train.capture")) == 1
    for net in (tr.ae, tr.disc):
        bind_generator(net, torch.Generator().manual_seed(9))
    for it in (6, 7):
        tr.train_step(batch, it, starts=starts)
    assert [s.attrs["graphed"] for s in _steps_named("train.step")] == [0, 1, 1, 0, 1]
    assert len(_steps_named("train.capture")) == 2 and len(tr._graphs) == 1


def test_graphs_of_the_least_recently_used_shapes_are_dropped(tmp_path, recorded, monkeypatch):
    from msmctts_tpu_torch.training import vqgan_trainer

    monkeypatch.setattr(vqgan_trainer, "GRAPHED_SHAPES", 2)
    tr = _trainer(tmp_path)
    for it, T in enumerate([32, 32, 40, 40, 48, 48, 32], start=3):
        tr.train_step(*_batch(T=T)[:1], it, starts=_batch(T=T)[1])
    assert [s.attrs["graphed"] for s in _steps_named("train.step")] == [0, 1, 0, 1, 0, 1, 0]
    assert [(k[1], g is not None) for k, (_, g) in tr._graphs.items()] == [(40, True), (48, True), (32, False)]


# ------------------------------------------------------------------- state


def test_capture_finds_the_trainer_as_the_step_found_it(tmp_path, recorded, monkeypatch):
    """A stub in place of the capture notes the trainer's state when the
    capture starts, at the shape's second sight: the generator, the weights,
    the codebooks and their statistics, each ``.grad`` and the optimizers'
    state are those the step was given; the first sight ran eagerly."""
    tr = _trainer(tmp_path)
    batch, starts = _batch()
    tr.train_step(batch, 3, starts=starts)  # the first sight: eager, optimizer state and grads exist
    assert not _steps_named("train.capture")
    for i, p in enumerate(tr.ae.parameters()):
        p.grad = None if i % 3 == 0 else torch.full_like(p, float(i))
    grads = [p.grad for net in (tr.ae, tr.disc) for p in net.parameters()]
    before = _state(tr)
    seen = {}

    class Stub:
        def __init__(self, modules, pool, generator):
            pass

        def capture(self, step):
            seen["state"] = _state(tr)
            seen["grads"] = [p.grad for net in (tr.ae, tr.disc) for p in net.parameters()]
            return step()

    monkeypatch.setattr(graphs, "StepGraphs", Stub)
    tr.train_step(batch, 4, starts=starts)
    assert len(_steps_named("train.capture")) == 1
    _same_state(seen["state"], before)
    assert all(a is b for a, b in zip(seen["grads"], grads))


def test_graphed_steps_equal_eager_steps(tmp_path, recorded, monkeypatch):
    """Five steps over two shapes, graphed and eager. The discriminator's
    parameter gradients of one update come from its two calls, each
    replayed apart: a leaf's contributions are summed per call and then
    over the calls, where one eager backward sums them in the order they
    arrive. The same sums to a rounding (observed: 4e-9 on the first
    step's gradients, 7e-7 on the weights after five steps at lr 2e-4)."""
    batches = [_batch(seed=s) for s in range(3)] + [_batch(T=40, seed=3), _batch(seed=4)]
    graphed = _trainer(tmp_path / "g")
    got = _run(graphed, batches)
    assert [s.attrs["graphed"] for s in _steps_named("train.step")] == [0, 1, 1, 0, 1]
    monkeypatch.setattr(graphs, "available", lambda device: False)
    eager = _trainer(tmp_path / "e")
    want = _run(eager, batches)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            torch.testing.assert_close(g[k], w[k], rtol=1e-5, atol=1e-6, msg=k)
    ga, gb = _state(graphed), _state(eager)
    for k in ga[0]:
        torch.testing.assert_close(ga[0][k], gb[0][k], rtol=0.0, atol=1e-5, msg=k)
    assert torch.equal(ga[2], gb[2])  # the generator drew as much


def test_replays_after_the_benchmarks_restore_repeat_the_first_steps(tmp_path, recorded):
    """The benchmark's restore: weights loaded in place, each optimizer's
    state before any update, the generator's state; then the same steps.
    The shape has been seen once before, so the first run captures and
    replays, the second replays alone."""
    tr = _trainer(tmp_path)
    weights = {n: copy.deepcopy(net.state_dict()) for n, net in (("ae", tr.ae), ("disc", tr.disc))}
    opts = {n: copy.deepcopy(o.state_dict()) for n, o in tr.optimizers.items()}
    rng = tr.generator.get_state()

    def restore():
        tr.ae.load_state_dict(weights["ae"])
        tr.disc.load_state_dict(weights["disc"])
        for n, o in tr.optimizers.items():
            o.load_state_dict(copy.deepcopy(opts[n]))
        tr.generator.set_state(rng)

    batches = [_batch(seed=s) for s in range(3)]
    _run(tr, batches[:1])  # the shape's first sight
    restore()
    first = _run(tr, batches)
    after_first = _state(tr)
    _run(tr, [_batch(seed=7)], first_iteration=6)  # the window moves everything on
    restore()
    again = _run(tr, batches)
    assert len(_steps_named("train.capture")) == 1
    for a, b in zip(first, again):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    _same_state(_state(tr), after_first)


def test_an_optimizer_put_back_before_any_update_steps_as_a_fresh_one(tmp_path):
    """``Optimizer.load_state_dict`` to the state before any update (lazily
    made Adam moments, count 0), then a step, equals a fresh trainer's."""
    tr = _trainer(tmp_path / "a")
    known = {n: copy.deepcopy(o.state_dict()) for n, o in tr.optimizers.items()}
    weights = {n: copy.deepcopy(net.state_dict()) for n, net in (("ae", tr.ae), ("disc", tr.disc))}
    rng = tr.generator.get_state()
    batch, starts = _batch()
    _run(tr, [_batch(seed=5), _batch(seed=6)])
    tr.ae.load_state_dict(weights["ae"])
    tr.disc.load_state_dict(weights["disc"])
    for n, o in tr.optimizers.items():
        o.load_state_dict(copy.deepcopy(known[n]))
    tr.generator.set_state(rng)
    got = _run(tr, [(batch, starts)])[0]
    fresh = _trainer(tmp_path / "b")
    want = _run(fresh, [(batch, starts)])[0]
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _same_state(_state(tr), _state(fresh))


def test_outside_graphs_runs_its_function_outside_a_capture():
    calls = []
    out = graphs.outside_graphs(lambda a, b: calls.append((a, b)) or (a + b,), torch.ones(2), torch.ones(2))
    assert torch.equal(out[0], torch.full((2,), 2.0)) and len(calls) == 1


def test_a_replayed_call_must_match_the_captured_one(tmp_path, recorded):
    tr = _trainer(tmp_path)
    batch, starts = _batch()
    tr.train_step(batch, 3, starts=starts)
    tr.train_step(batch, 4, starts=starts)
    _, steps = tr._graphs[(4, 32, tr.frame_lengths)]
    with pytest.raises(RuntimeError, match="differs from the call captured"):
        steps.replay(lambda: tr.ae(batch["mel"][:, :16], batch["mel_length"]))


def test_dropped_graphs_are_freed_at_once(tmp_path, recorded):
    """Nothing in a step's graphs refers back to them: dropped, they go by
    reference counting alone, with their memory, without waiting for the
    interpreter's cycle collector."""
    import gc
    import weakref

    tr = _trainer(tmp_path)
    batch, starts = _batch()
    for it in (3, 4, 5):
        tr.train_step(batch, it, starts=starts)
    _, steps = tr._graphs.pop((4, 32, tr.frame_lengths))
    gone = [weakref.ref(steps), weakref.ref(steps.passes[0]), weakref.ref(steps.passes[0].pieces[0])]
    gc.disable()
    try:
        del steps
        assert [w() for w in gone] == [None, None, None]
    finally:
        gc.enable()
