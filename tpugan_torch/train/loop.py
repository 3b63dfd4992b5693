"""Training-loop plumbing (``tpugan/train/loop.py``): the fused multi-step
dispatch ``graph_steps``, the per-step metrics sink, the step observer of the
observability flags, the trainers' device, and the generic loop
``run_training``.

``--steps_per_dispatch K`` above 1 runs K optimizer steps a dispatch, the
counterpart of the JAX package's ``scan_steps``: on CUDA one CUDA graph of
the K steps, captured once and replayed; on the CPU a Python loop over the
same K steps. ``StepObserver`` carries ``--metrics_jsonl``,
``--profile_dir``/``--profile_steps`` (a ``torch.profiler`` trace, counted
in dispatches) and ``--debug_numerics`` (autograd's anomaly mode and a check
of each step's scalars); every loop of the port builds one and ticks it once
a device dispatch. ``--profile_port`` is refused here, where every loop
starts, with its reason.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Callable, Optional

import torch

from tpugan_torch.parallel import mesh
from tpugan_torch.utils.config import set_process_modes

# Flags of the JAX package that the port refuses, with the reason.
_UNPORTED = {
    "profile_port": (
        "torch has no live profiler server: Kineto's on-demand tracing needs the dynolog "
        "daemon, which the port neither ships nor can install; trace a fixed window with "
        "--profile_dir instead (ROADMAP, Not ported)"),
}

# The capture's error mode: "thread_local" leaves the loader's thread free
# to pin and copy the next batches while the main thread captures.
CAPTURE_ERROR_MODE = "thread_local"

# Graph replays of every ``graph_steps`` since the last reset (a replay runs
# the K captured steps once).
graph_replays = 0


def reset_graph_counts() -> None:
    global graph_replays
    graph_replays = 0


def reject_unported_flags(cfg) -> None:
    """Raise NotImplementedError for a flag set away from its default that
    the port does not implement."""
    for name, reason in _UNPORTED.items():
        if getattr(cfg, name, None):
            raise NotImplementedError(f"--{name} is not ported: {reason}")


def card_device(device=None) -> torch.device:
    """The device an entry point of the port runs on: CUDA when ``device``
    is None, raising when there is none (the tests pass the CPU); under a
    launcher that sets ``LOCAL_RANK`` (``torchrun``), that rank's card, made
    the current device. On CUDA, float32 means TF32 off for convolutions and
    matmuls, whatever the compute dtype: under bfloat16 the layers that stay
    float32 (norm statistics, the ResNet18 trunk, the GP) stay exact
    float32."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("tpugan_torch runs on CUDA and found no CUDA device")
        local = os.environ.get("LOCAL_RANK")
        device = torch.device("cuda") if local is None else torch.device("cuda", int(local))
        if local is not None:
            torch.cuda.set_device(device)
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


def train_device(cfg, device=None) -> torch.device:
    """The device a trainer's ``run`` trains on (``card_device``). Refuses
    the unported flag and sets the process-wide modes of ``cfg``
    (``set_process_modes``: a config built in code has not been through
    ``config_from_args``)."""
    device = card_device(device)
    reject_unported_flags(cfg)
    set_process_modes(cfg)
    return device


def heavy_out_keys(out: dict) -> list:
    """The entries of a step's ``out`` that ``graph_steps`` carries from the
    last step instead of stacking: every one that is not a 0-d tensor."""
    return [n for n, v in out.items() if v.ndim > 0]


def _stack_batches(batches) -> tuple:
    """Stack a list of per-step batch tuples along a new leading K axis."""
    return tuple(torch.stack(xs) for xs in zip(*batches))


class GraphSteps:
    """``steps(state, *stacked) -> (state, out)``: K steps of ``step_fn``
    (``(state, *args) -> (state, out)``, ``out`` a flat dict) in one
    dispatch, the contract of ``scan_steps`` (``tpugan/train/loop.py:19``).
    Each argument carries a leading K axis, one entry a step. Every 0-d
    entry of ``out`` comes back stacked to shape (K,); every other entry
    (``gen_imgs``) comes from the last step. ``heavy_keys`` names the
    latter once a call has run.

    On a CUDA state the first call runs its K steps eagerly: the warm-up
    that creates the optimizers' state, lets cuDNN pick its algorithms and
    fills the kernels' plan caches. The second call captures the K steps
    into one ``torch.cuda.CUDAGraph``, reading the K batches from static
    buffers, with the state's generator ``state.draws`` registered so that
    the graph's draws continue its stream, then replays it; every later call
    copies its batches in and replays. ``state.step`` advances on the host
    by the capture's count a replay. The returned ``out`` is the graph's
    static output: the next replay overwrites it, so clone what outlives
    the dispatch. A failed capture or replay raises; nothing falls back to
    eager steps.

    On a CPU state (the tests' choice) every call runs the K steps in a
    Python loop and stacks the results the same way."""

    def __init__(self, step_fn: Callable, k: int):
        if k < 1:
            raise ValueError(f"steps per dispatch {k}, expected at least 1")
        self.step_fn, self.k = step_fn, k
        self.heavy_keys: Optional[list] = None
        self.calls = 0
        self.replays = 0
        self.graph = None
        # Set at capture: host seconds of the capture (the K steps' Python)
        # and of the instantiation, and max_memory_allocated around it.
        self.capture_s = self.instantiate_s = None
        self.memory_before = self.memory_after = None
        self._inputs = self._out = None
        self._step_delta = 0

    def _run(self, state, stacked):
        outs = []
        for j in range(self.k):
            state, out = self.step_fn(state, *(a[j] for a in stacked))
            outs.append(out)
        if self.heavy_keys is None:
            self.heavy_keys = heavy_out_keys(outs[0])
        return state, {n: outs[-1][n] if n in self.heavy_keys else torch.stack([o[n] for o in outs])
                       for n in outs[0]}

    def __call__(self, state, *stacked):
        bad = [tuple(a.shape) for a in stacked if a.shape[0] != self.k]
        if bad:
            raise ValueError(f"graph_steps: leading axes {bad}, expected {self.k} steps")
        self.calls += 1
        if state.draws.device.type != "cuda" or self.calls == 1:
            return self._run(state, stacked)
        if self.graph is None:
            self._capture(state, stacked)
        else:
            for buf, a in zip(self._inputs, stacked):
                if buf.shape != a.shape or buf.dtype != a.dtype:
                    raise ValueError(f"graph_steps: input {tuple(a.shape)} {a.dtype}, the graph "
                                     f"was captured for {tuple(buf.shape)} {buf.dtype}")
                buf.copy_(a)
        self._replay(state)
        return state, self._out

    def _capture(self, state, stacked) -> None:
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.draws)
        self._inputs = [a.clone() for a in stacked]
        step0 = state.step
        self.memory_before = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, capture_error_mode=CAPTURE_ERROR_MODE):
            _, self._out = self._run(state, self._inputs)
            t1 = time.perf_counter()
        self.instantiate_s, self.capture_s = time.perf_counter() - t1, t1 - t0
        self.memory_after = torch.cuda.max_memory_allocated()
        self._step_delta, state.step = state.step - step0, step0
        self.graph = graph

    def _replay(self, state) -> None:
        global graph_replays
        self.graph.replay()
        state.step += self._step_delta
        self.replays += 1
        graph_replays += 1


def graph_steps(step_fn: Callable, k: int, dp=None) -> GraphSteps:
    """K steps of ``step_fn`` a dispatch (``GraphSteps``): the port's
    ``scan_steps``. Under data parallelism ``dp`` must be an NCCL group,
    whose collectives the graph captures with the steps
    (``mesh.check_fusable``)."""
    mesh.check_fusable(dp)
    return GraphSteps(step_fn, k)


def host_rows(out: dict, heavy_keys, k: int) -> list:
    """The K per-step rows of a fused dispatch's ``out``, with one
    device-to-host read of all its stacked scalars; each row carries the
    heavy entries (the dispatch's last step's) as they are."""
    names = [n for n in out if n not in heavy_keys]
    host = torch.stack([out[n] for n in names]).cpu() if names else None
    return [{**{n: host[a, j] for a, n in enumerate(names)},
             **{n: out[n] for n in heavy_keys}} for j in range(k)]


class MetricsSink:
    """jsonl per-step scalar sink: one line ``{"step": N, name: value, ...}``
    for each observed step, from the scalars (0-d tensors or numbers) of a
    dict; other entries, such as the generated images, are left out. Reading
    a CUDA scalar waits for the step."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "a")

    def write(self, step: int, out: dict) -> None:
        rec = {"step": step, **{k: float(v) for k, v in out.items()
                                if getattr(v, "ndim", 0) == 0}}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


def fused_k(cfg) -> int:
    """The steps a dispatch of a loop that fuses (``run_training``,
    ``run_critic_family``): ``--steps_per_dispatch``, or 1 with a notice
    under ``--debug_numerics``, whose anomaly mode synchronizes, which a
    CUDA-graph capture cannot (the port's one deviation from the JAX
    package's flag, which checks inside its fused scan)."""
    k = max(1, int(getattr(cfg, "steps_per_dispatch", 1)))
    if k > 1 and getattr(cfg, "debug_numerics", False):
        print("[tpugan] --debug_numerics runs one step per dispatch (autograd's anomaly "
              "mode synchronizes, which a CUDA-graph capture cannot); "
              "--steps_per_dispatch %d ignored" % k)
        return 1
    return k


def first_nonfinite(out: dict) -> Optional[str]:
    """The name of the first 0-d floating entry of ``out`` that is not
    finite, with one device-to-host read of them all, or None."""
    names = [n for n, v in out.items()
             if torch.is_tensor(v) and v.ndim == 0 and v.is_floating_point()]
    if not names:
        return None
    ok = torch.isfinite(torch.stack([out[n].detach().float() for n in names])).tolist()
    return next((n for n, good in zip(names, ok) if not good), None)


class StepObserver:
    """Wires the observability flags into a training loop
    (``tpugan/train/loop.py:99-175``). Every loop of the port builds one and
    calls ``observe`` once a step, or ``profile_tick`` once a fused dispatch
    and ``observe(..., dispatch=False)`` for each of its rows.

    - ``--metrics_jsonl``: one line a step (``MetricsSink``).
    - ``--profile_dir D --profile_steps N``: a ``torch.profiler`` trace
      (CPU and, on a CUDA machine, CUDA activity) of dispatches
      [1, 1 + ceil(N / S)), S the optimizer steps a dispatch: K under
      ``--steps_per_dispatch`` K, ``K * (n_critic + 1)`` for the critic
      family (``dispatch_steps``), 1 for a loop that does not fuse.
      Dispatch 0 holds the warm-up (cuDNN's algorithm search, the optimizers'
      state). Counting dispatches, not steps, keeps a replayed graph whole
      and works on a resumed run. The trace is TensorBoard's
      (``tensorboard_trace_handler(D)``: ``D/<host>_<pid>.<ns>.pt.trace.json``),
      and each traced dispatch is a range named ``tpugan.dispatch.<n>`` in
      it; ``traced`` lists them. The device is synchronized before the
      trace stops, as the JAX package blocks on the outputs.
    - ``--debug_numerics``: ``checked(step)`` runs a step under autograd's
      anomaly mode, whose NaN check covers the backward of every
      ``autograd.Function`` (the IN, AdaIN and GP kernels included), and
      then reads the step's scalars; a NaN found either way raises
      ``FloatingPointError`` naming it, as ``jax_debug_nans`` does.

    A loop that does not fuse (``supports_fused_dispatch`` False: the
    bespoke loops) prints the JAX package's notice when
    ``--steps_per_dispatch`` is above 1 and runs one step at a time
    (``tpugan/train/loop.py:108-124``)."""

    def __init__(self, cfg, supports_fused_dispatch: bool = False, dispatch_steps: int = 1):
        if not supports_fused_dispatch and getattr(cfg, "steps_per_dispatch", 1) > 1:
            print(
                "[tpugan] --steps_per_dispatch is not supported by this "
                "recipe's training loop (per-step host logic); running "
                "one step per dispatch"
            )
        # Rank 0 alone writes the metrics and the trace.
        writer = mesh.is_writer()
        path = getattr(cfg, "metrics_jsonl", "")
        self.sink = MetricsSink(path) if path and writer else None
        self.profile_dir = getattr(cfg, "profile_dir", "") if writer else ""
        self.profile_dispatches = max(1, -(-int(getattr(cfg, "profile_steps", 5))
                                           // dispatch_steps))
        self.debug_numerics = bool(getattr(cfg, "debug_numerics", False))
        self.traced = []
        self._profiler = self._range = None
        self._calls = 0

    def checked(self, step_fn: Callable) -> Callable:
        """``step_fn`` itself, or under ``--debug_numerics`` ``step_fn``
        under anomaly mode followed by ``first_nonfinite`` of its ``out``."""
        if not self.debug_numerics:
            return step_fn

        def step(*args, **kwargs):
            with torch.autograd.set_detect_anomaly(True):
                try:
                    state, out = step_fn(*args, **kwargs)
                except RuntimeError as e:
                    if "nan values" not in str(e):
                        raise
                    raise FloatingPointError(f"--debug_numerics: {e}") from e
            bad = first_nonfinite(out)
            if bad is not None:
                raise FloatingPointError(
                    f"--debug_numerics: step output {bad!r} is {float(out[bad])}")
            return state, out

        return step

    def _open_range(self, n: int) -> None:
        self._range = torch.profiler.record_function(f"tpugan.dispatch.{n}")
        self._range.__enter__()

    def _stop(self) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self._profiler.stop()
        self._profiler = None

    def profile_tick(self) -> None:
        """Advance the profile window by one device dispatch, the one just
        issued: after dispatch 0 the trace starts, after dispatch
        ``profile_dispatches`` it stops."""
        n, self._calls = self._calls, self._calls + 1
        if not self.profile_dir:
            return
        if n == 0:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(self.profile_dir))
            self._profiler.start()
            self._open_range(1)
        elif self._profiler is not None:
            self._range.__exit__(None, None, None)
            self._range = None
            self.traced.append(n)
            if n >= self.profile_dispatches:
                self._stop()
            else:
                self._open_range(n + 1)

    def observe(self, batches_done: int, out: dict, dispatch: bool = True) -> None:
        if dispatch:
            self.profile_tick()
        if self.sink is not None:
            self.sink.write(batches_done, out)

    def close(self) -> None:
        """Stop a trace still open (a run shorter than its window) and close
        the sink."""
        if self._profiler is not None:
            self._stop()
        if self.sink is not None:
            self.sink.close()


@dataclasses.dataclass
class Callbacks:
    # log(epoch, batch_idx, batches_per_epoch, out_dict)
    log: Optional[Callable[[int, int, int, dict], None]] = None
    # sample(state, out_dict, batches_done)
    sample: Optional[Callable[[Any, dict, int], None]] = None
    # epoch_end(state, epoch) -> state | None
    epoch_end: Optional[Callable[[Any, int], Any]] = None


def run_training(cfg, loader, state, step_fn, callbacks: Callbacks, n_epochs: int,
                 sample_interval: int = 0):
    """The generic loop of ``tpugan/train/loop.py:run_training``: ``state,
    out = step_fn(state, *batch)`` for each batch, up to ``--max_batches``
    an epoch; ``out`` goes to ``--metrics_jsonl``, to ``callbacks.log`` every
    ``--log_interval`` batches and to ``callbacks.sample`` whenever
    ``batches_done`` (epoch * batches an epoch + batch) is a multiple of
    ``sample_interval``.

    ``--steps_per_dispatch K`` above 1 gathers K batches and runs them in
    one ``graph_steps`` dispatch, then replays the host's work step by step
    from the stacked scalars (one device-to-host read a dispatch). A sample
    due inside a dispatch takes the dispatch's last ``gen_imgs``, up to K-1
    steps newer than its file name says: the JAX package's documented
    deviation (a K that divides ``sample_interval`` is exact). The epoch's
    tail shorter than K, and a ragged last batch (``--ragged_last_batch``)
    with the full ones before it, run one eager step at a time after the
    last replay, never a capture at the new shape. ``callbacks.epoch_end``
    runs after each epoch, its tail included; a state it returns replaces
    the loop's. ``--debug_numerics`` runs one step a dispatch
    (``fused_k``), each ``observer.checked``. Under data parallelism
    (``state.dp``) rank 0 alone logs; every rank calls ``callbacks.sample``,
    which may gather."""
    bpe = len(loader)
    if cfg.max_batches >= 0:
        bpe = min(bpe, cfg.max_batches)
    k = fused_k(cfg)
    observer = StepObserver(cfg, supports_fused_dispatch=True, dispatch_steps=k)
    step_fn = observer.checked(step_fn)
    steps = graph_steps(step_fn, k, getattr(state, "dp", None)) if k > 1 else None
    log = callbacks.log if mesh.is_writer() else None

    def after_step(state, out, epoch, i, dispatch=True):
        batches_done = epoch * bpe + i
        observer.observe(batches_done, out, dispatch)
        if log and cfg.log_interval > 0 and i % cfg.log_interval == 0:
            log(epoch, i, bpe, out)
        if callbacks.sample and sample_interval > 0 and batches_done % sample_interval == 0:
            callbacks.sample(state, out, batches_done)

    for epoch in range(n_epochs):
        pending = []  # (i, batch) awaiting a full dispatch
        with contextlib.closing(loader.epoch(epoch)) as batches:
            for i, batch in enumerate(batches):
                if cfg.max_batches >= 0 and i >= cfg.max_batches:
                    break
                if steps is None:
                    state, out = step_fn(state, *batch)
                    after_step(state, out, epoch, i)
                    continue
                ragged = bool(pending) and batch[0].shape[0] != pending[0][1][0].shape[0]
                pending.append((i, batch))
                if ragged:  # the ragged tail: flushed eagerly below
                    break
                if len(pending) < k:
                    continue
                first_i = pending[0][0]
                state, out = steps(state, *_stack_batches([b for _, b in pending]))
                observer.profile_tick()
                pending = []
                for j, row in enumerate(host_rows(out, steps.heavy_keys, k)):
                    after_step(state, row, epoch, first_i + j, dispatch=False)
        for i, batch in pending:  # the epoch's tail, shorter than K, ragged or not
            state, out = step_fn(state, *batch)
            after_step(state, out, epoch, i)
        if callbacks.epoch_end is not None:
            state = callbacks.epoch_end(state, epoch) or state
    observer.close()
    return state
