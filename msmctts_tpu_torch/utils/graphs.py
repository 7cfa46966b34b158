"""CUDA graphs of a train step's network calls (``torch.cuda.CUDAGraph``).

A step that runs the same kernels on the same shapes every time spends
most of its host time launching them: a GAN step of the CSMSC recipe makes
some 13k launches. :class:`StepGraphs` takes the calls of a few networks
(``nn.Module``\\ s) inside such a step off the host. On the step's first run
at a shape (:meth:`StepGraphs.capture`) every call of those networks is
captured as it runs: its forward as CUDA graphs, its backward as one more
when autograd reaches it. Later runs (:meth:`StepGraphs.replay`) run the
same step code, and every network call replays its graphs in place of the
forward's Python, on the tensors the capture saw; the losses, the
optimizers and whatever else the step does between the calls stay eager.

A call (:class:`_Pass`) is recognised by its place in the step: the k-th
call of a network replays what the k-th call captured, after a check that
its inputs have the captured shapes and dtypes. Its inputs are copied into
tensors of its own, unless they are outputs of an earlier call, which it
reads where they lie; parameters and buffers are read where they live, so state put back
in place (``load_state_dict``, ``Optimizer.load_state_dict``,
``Generator.set_state``) is what the next replay reads. Its outputs are the
captured tensors, which the next replay overwrites. An autograd node joins
them to the step's graph: its backward copies the incoming gradients in,
replays the backward graph and hands autograd the captured gradients of the
inputs and parameters, which it accumulates into ``.grad`` as it would the
eager ones.

:func:`outside_graphs` cuts a forward: what it runs stays eager, on every
replay, between the graphs before and after it (the codebook statistics
and their EMA update, ``models/quantizer.py``). Random draws come from the
generator each graph registers (``CUDAGraph.register_generator_state``): a
replay draws what the eager forward would draw from the generator's state.

All graphs share one memory pool. They are captured in the order the step
runs them, so that a graph reuses only memory that is dead whenever it
replays; graphs of different shapes never run inside one step, so they may
share the pool as well. Capture runs on a side stream (:func:`side_stream`),
after a warm-up on it that builds every lazily made plan, workspace and
constant first (the caller's, see ``training/vqgan_trainer.py``).
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, List, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

__all__ = ["StepGraphs", "available", "capture_stream", "outside_graphs", "side_stream"]

_local = threading.local()  # ``capturing``: the call whose forward this thread is capturing


def available(device: torch.device) -> bool:
    """Whether ``device``'s work can be captured as CUDA graphs."""
    return device.type == "cuda"


_streams: dict = {}  # device -> the side stream of every capture on it


def capture_stream(device: torch.device) -> Optional["torch.cuda.Stream"]:
    """The side stream that captures on ``device`` run on (None off a
    card): one a process, as ``torch.cuda.graph`` keeps one, so that what
    its eager work caches serves every later capture, of any trainer."""
    if device.type != "cuda":
        return None
    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device)
    return _streams[device]


class CudaGraph:
    """One CUDA graph in the shared pool, with the generator it draws from
    registered. ``runs_on_capture`` is False: capture records the kernels
    without running them, so a segment is replayed once right after it."""

    runs_on_capture = False

    def __init__(self, pool, generator: Optional[torch.Generator]):
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        self.pool = pool

    def begin(self):
        self.graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")

    def end(self):
        self.graph.capture_end()

    def replay(self):
        self.graph.replay()


@contextlib.contextmanager
def side_stream(stream: Optional["torch.cuda.Stream"]):
    """Run the block on ``stream`` (nothing to do for None), ordered after
    the current stream's work and before what the current stream does next."""
    if stream is None:
        yield
        return
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        yield
    current.wait_stream(stream)


def outside_graphs(fn: Callable, *args):
    """``fn(*args)``, also while a network call is being captured: the
    capture then stops before ``fn`` and resumes after it, and every replay
    runs ``fn`` on the same tensors and copies its results to where the
    capture left them. ``fn`` returns a tuple of tensors that take no
    gradient."""
    call = getattr(_local, "capturing", None)
    return fn(*args) if call is None else call.cut(fn, args)


def _copy_in(dsts: List[torch.Tensor], srcs: Sequence[torch.Tensor]):
    """Copy each source into its destination unless it already is it."""
    pairs = [(d, s) for d, s in zip(dsts, srcs) if d.data_ptr() != s.data_ptr()]
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


class _Graphed(torch.autograd.Function):
    """The autograd node of one replayed call: inputs are the call's tensor
    inputs and its parameters that take a gradient."""

    @staticmethod
    def forward(ctx, call, *inputs):
        ctx.call = call
        ctx.set_materialize_grads(False)
        outs = tuple(o.detach() for o in call.out_tensors)
        ctx.mark_non_differentiable(*(o for o, d in zip(outs, call.out_diff) if not d))
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        return (None,) + ctx.call.backward(grads)


class _Pass:
    """One network call of the step: its forward as graph segments and the
    cuts between them, its backward as one graph, and the tensors they
    read and write."""

    def __init__(self, steps: "StepGraphs", module: torch.nn.Module, args, kwargs):
        # what it needs of the step, not the step: no cycle keeps a dropped step's graphs alive
        self.pool, self.generator = steps.pool, steps.generator
        self.module = module
        leaves, self.in_spec = pytree.tree_flatten((args, kwargs))
        self.in_kinds = [isinstance(x, torch.Tensor) for x in leaves]
        self.in_consts = [x for x, t in zip(leaves, self.in_kinds) if not t]
        # the captured graph's leaves: an output of an earlier call is used
        # where it lies, any other input through a copy of its own
        self.inputs = [(x.detach() if x.untyped_storage().data_ptr() in steps.outputs else x.detach().clone())
                       .requires_grad_(x.requires_grad) for x, t in zip(leaves, self.in_kinds) if t]
        self.sealed = False  # the step's capture is over: a backward not captured with it is refused
        self.params = [p for p in module.parameters() if p.requires_grad]
        self.frozen = [p for p in module.parameters() if not p.requires_grad]
        self.pieces: list = []  # graphs, and (fn, args, outs) of the cuts, in order
        self.bwd = None

    def _name(self) -> str:
        return type(self.module).__name__

    def _new_graph(self) -> CudaGraph:
        return CudaGraph(self.pool, self.generator)

    # --------------------------------------------------------------- capture
    def _begin(self):
        graph = self._new_graph()
        graph.begin()
        self.pieces.append(graph)
        self.open = True

    def _end(self):
        graph = self.pieces[-1]
        self.open = False
        graph.end()
        if not graph.runs_on_capture:
            graph.replay()

    def cut(self, fn, args):
        self._end()
        outs = fn(*args)
        if any(o.requires_grad for o in outs):
            raise RuntimeError("what runs outside the graphs of a forward must return tensors that take no gradient")
        self.pieces.append((fn, args, outs))
        self._begin()
        return outs

    def capture(self, forward):
        tensors, consts = iter(self.inputs), iter(self.in_consts)
        args, kwargs = pytree.tree_unflatten([next(tensors) if t else next(consts) for t in self.in_kinds],
                                             self.in_spec)
        _local.capturing = self
        self._begin()
        try:
            out = forward(*args, **kwargs)
        finally:
            _local.capturing = None
            if self.open:
                self._end()
        leaves, self.out_spec = pytree.tree_flatten(out)
        self.out_kinds = [isinstance(x, torch.Tensor) for x in leaves]
        self.out_consts = [x for x, t in zip(leaves, self.out_kinds) if not t]
        self.out_tensors = [x for x, t in zip(leaves, self.out_kinds) if t]
        self.out_diff = [x.requires_grad for x in self.out_tensors]

    def _capture_backward(self, grads):
        self.used = [i for i, g in enumerate(grads) if g is not None]
        self.grad_outs = [torch.empty_like(self.out_tensors[i]) for i in self.used]
        _copy_in(self.grad_outs, [grads[i] for i in self.used])
        wrt = [x for x in self.inputs if x.requires_grad] + self.params
        self.bwd = self._new_graph()
        self.bwd.begin()
        try:
            got = torch.autograd.grad([self.out_tensors[i] for i in self.used], wrt, self.grad_outs,
                                      allow_unused=True)
        finally:
            self.bwd.end()
        if not self.bwd.runs_on_capture:
            self.bwd.replay()
        got = iter(got)
        self.grad_ins = [next(got) if x.requires_grad else None for x in self.inputs] + [next(got) for _ in self.params]
        self.out_tensors = [o.detach() for o in self.out_tensors]  # the captured autograd graph is spent

    # ---------------------------------------------------------------- replay
    def replay_forward(self, args, kwargs) -> List[torch.Tensor]:
        """Replay the forward on these inputs; returns their tensors."""
        leaves, spec = pytree.tree_flatten((args, kwargs))
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        if (spec != self.in_spec or [x for x in leaves if not isinstance(x, torch.Tensor)] != self.in_consts
                or any(x.shape != s.shape or x.dtype != s.dtype or x.requires_grad != s.requires_grad
                       for x, s in zip(tensors, self.inputs))):
            raise RuntimeError(f"a call of {self._name()} differs from the call captured at its place in the step")
        if not all(p.requires_grad for p in self.params) or any(p.requires_grad for p in self.frozen):
            raise RuntimeError(f"{self._name()}'s parameters take other gradients than when its call was captured")
        _copy_in(self.inputs, tensors)
        for piece in self.pieces:
            if isinstance(piece, tuple):
                fn, cut_args, outs = piece
                _copy_in(list(outs), fn(*cut_args))
            else:
                piece.replay()
        return tensors

    def result(self, tensors: List[torch.Tensor]):
        """The call's outputs, joined to the step's autograd graph through
        ``tensors`` (the call's tensor inputs) and its parameters."""
        if any(self.out_diff):
            outs = _Graphed.apply(self, *tensors, *self.params)
        else:
            outs = tuple(o.detach() for o in self.out_tensors)
        outs, consts = iter(outs), iter(self.out_consts)
        return pytree.tree_unflatten([next(outs) if t else next(consts) for t in self.out_kinds], self.out_spec)

    def backward(self, grads) -> tuple:
        if self.bwd is None:
            if self.sealed:
                raise RuntimeError(f"{self._name()}'s backward was not captured with the step")
            self._capture_backward(grads)
        else:
            if [i for i, g in enumerate(grads) if g is not None] != self.used:
                raise RuntimeError(f"{self._name()}'s backward gets other gradients than when it was captured")
            _copy_in(self.grad_outs, [grads[i] for i in self.used])
            self.bwd.replay()
        return tuple(None if g is None else g.detach() for g in self.grad_ins)


class StepGraphs:
    """The network calls of one step at one input shape: captured on the
    step's first run, replayed on the later ones; every graph in ``pool``,
    drawing from ``generator``."""

    def __init__(self, modules: Sequence[torch.nn.Module], pool, generator: Optional[torch.Generator]):
        self.modules = list(modules)
        self.pool = pool
        self.generator = generator
        self.passes: List[_Pass] = []
        self.outputs = set()  # the storages of the calls' outputs
        self.captured = False

    def capture(self, step: Callable):
        """``step()``, capturing every call of the networks as it runs."""
        if self.captured:
            raise RuntimeError("this step is captured already")
        out = self._run(step, None)
        self.captured = True
        for call in self.passes:
            call.sealed = True
        return out

    def replay(self, step: Callable):
        """``step()``, every call of the networks replaying its graphs."""
        if not self.captured:
            raise RuntimeError("this step has not been captured")
        calls = iter(self.passes)
        out = self._run(step, calls)
        if next(calls, None) is not None:
            raise RuntimeError("the step called its networks fewer times than when it was captured")
        return out

    def _run(self, step, calls):
        def routed(module, forward, /, *args, **kwargs):
            if calls is None:
                call = _Pass(self, module, args, kwargs)
                call.capture(forward)
                self.passes.append(call)
                self.outputs.update(x.untyped_storage().data_ptr() for x in call.out_tensors)
                tensors = [x for x in pytree.tree_leaves((args, kwargs)) if isinstance(x, torch.Tensor)]
            else:
                call = next(calls, None)
                if call is None or call.module is not module:
                    raise RuntimeError("the step calls its networks in another order than when it was captured")
                tensors = call.replay_forward(args, kwargs)
            return call.result(tensors)

        # the module is still called, so its hooks run around the replay
        own = [vars(m).get("forward") for m in self.modules]
        for m in self.modules:
            m.forward = functools.partial(routed, m, m.forward)
        try:
            return step()
        finally:
            for m, forward in zip(self.modules, own):
                if forward is None:
                    del m.forward
                else:
                    m.forward = forward
