"""What makes ``torch.profiler`` lose a kernel's device events, on the card.

    python -m xfmamba_tpu_torch.kernels.trace_probe                # every case
    python -m xfmamba_tpu_torch.kernels.trace_probe LINK BEFORE    # one case
    python -m xfmamba_tpu_torch.kernels.trace_probe --smoke        # chip_smoke's phases

Each case runs in a fresh process.  It loads the kernel library linked with
the CUDA runtime ``static`` (nvcc's default) or ``shared``, or no library
(``none``: torch's own kernel is traced), runs ``BEFORE``:

- ``nothing``;
- ``kernels``: a float32 XFMamba-T train step and eval forward at batch 2
  (the training and inference kernels, cluster launches included);
- ``graph``: the traced kernel captured in a CUDA graph and replayed;
- ``profile``: a first ``utils.profiling.trace`` of the same calls;

then traces ten calls of the device preprocessing kernel (or, without the
library, of ``torch.mul``) beside ten ``torch.mul`` calls with
``utils.profiling.trace`` without its guard, and prints one JSON line: the kernel's device
events, torch's ``mul`` device events, and the CUDA runtimes mapped into the
process.  Without arguments it runs every case, then asks which gloo
collectives take CUDA tensors (two processes on card 0) and runs an NCCL
all-reduce in a world of one.  With ``--smoke`` it runs ``chip_smoke.py``
from the repository's root and, after each of its phases, the trace of ten
calls (one JSON line a phase), to find the phase after which the trace
loses its device events; ``--heavy`` traces after a long profile of three
bs-16 steps; ``--degrade`` runs launches for five minutes and compares the
trace's variants every 15 s (`_variants`).
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from xfmamba_tpu_torch.parallel.distributed import free_port

LINKS = {"static": (), "shared": ("-cudart", "shared", "-Xlinker", "-rpath=/usr/local/cuda/lib64")}
BEFORE = ("nothing", "kernels", "graph", "profile")
HEAVY_ROUNDS = 4
PREFIX = 256


def _runtimes():
    with open("/proc/self/maps") as f:
        return sorted({line.split()[-1] for line in f if "libcudart" in line})


def _traced_calls():
    from xfmamba_tpu_torch.data import device_pipeline as dp
    g = torch.Generator().manual_seed(0)
    stage = dp.mura_device_preprocess((224, 224), seed=1)
    u8 = torch.randint(0, 256, (16, 224, 224, 1), generator=g, dtype=torch.uint8).cuda()
    rows = stage.rows(stage.draw_params(16)).cuda()
    return lambda: stage.train_batch(u8, rows)


def _kernels_before():
    from xfmamba_tpu_torch.models.tops import two_view_xfmamba
    from xfmamba_tpu_torch.train import loop
    from xfmamba_tpu_torch.train.config import TrainConfig
    model = two_view_xfmamba("tiny", seed=0)
    opt = loop.make_optimizer(TrainConfig(), model.parameters())
    step, evaluate = loop.make_train_step(model, opt, multilabel=False)
    g = torch.Generator().manual_seed(1)
    batch = {"image1": torch.randn(2, 224, 224, 1, generator=g).cuda(),
             "image2": torch.randn(2, 224, 224, 1, generator=g).cuda(),
             "label": torch.tensor([0, 1]).cuda()}
    step(batch)
    evaluate(batch)
    torch.cuda.synchronize()


def run_case(link: str, before: str) -> dict:
    from xfmamba_tpu_torch.kernels import build
    from xfmamba_tpu_torch.utils import profiling
    x = torch.ones(1 << 20, device="cuda")
    if link == "none":
        call = lambda: x * 3  # noqa: E731
        name = "mul"
    else:
        build.LINK_FLAGS = LINKS[link]
        build.library()
        call = _traced_calls()
        name = "device_preprocess"
    call()
    if before == "kernels":
        _kernels_before()
    elif before == "graph":
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            call()
        for _ in range(3):
            graph.replay()
    torch.cuda.synchronize()
    counts = []
    with tempfile.TemporaryDirectory() as logdir:
        for session in range(2 if before == "profile" else 1):
            with profiling.trace(logdir, f"trace{session}.json", edge=0):
                for _ in range(10):
                    call()
                    x.mul(2.0)
            with open(os.path.join(logdir, f"trace{session}.json")) as f:
                events = [e for e in json.load(f).get("traceEvents", [])
                          if e.get("cat") == "kernel"]
            counts.append({"kernel": sum(name in e.get("name", "") for e in events),
                           "mul": sum("mul" in e.get("name", "").lower() for e in events),
                           "all_kernels": len(events)})
    return {"link": link, "before": before, "sessions": counts, "cudart": _runtimes()}


def _gloo_rank(rank: int, port: int, out: str) -> None:
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    x = torch.full((4,), float(rank + 1), device="cuda")
    result = {}
    tries = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(2)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8, device="cuda"), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(2, device="cuda"), x),
    }
    for key, fn in tries.items():
        try:
            fn()
            torch.cuda.synchronize()
            result[key] = "ok"
        except Exception as e:  # record what gloo refuses
            result[key] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
        dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(result, f)


def _nccl_one() -> dict:
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    x = torch.arange(4.0, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    dist.destroy_process_group()
    return {"nccl_world_of_one": x.tolist()}


@contextlib.contextmanager
def _sleep_trace(logdir, filename="trace.json", guard_s=0.05):
    """``utils.profiling.trace`` with idle time alone around the block (no
    operation at the window's edges): the first repair tried."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(guard_s)
        yield prof
        torch.cuda.synchronize()
        time.sleep(guard_s)
    prof.export_chrome_trace(os.path.join(logdir, filename))


def _trace_counts(call, name, x, tracer=None) -> dict:
    """Ten calls and ten ``mul`` under ``tracer`` (default:
    ``utils.profiling.trace`` as it is): the device events kept, and in
    microseconds the earliest kernel's start after the first launch call,
    and the least (kernel start - its launch call)."""
    from xfmamba_tpu_torch.utils import profiling
    tracer = tracer or profiling.trace
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as logdir:
        with tracer(logdir) as prof:
            for _ in range(10):
                call()
                x.mul(2.0)
        with open(os.path.join(logdir, "trace.json")) as f:
            every = json.load(f).get("traceEvents", [])
        rows = sum(1 for e in prof.key_averages() if name in e.key and getattr(
            e, "device_time_total", getattr(e, "cuda_time_total", 0)) > 0)
    events = [e for e in every if e.get("cat") == "kernel"]
    launches = {e["args"]["correlation"]: e["ts"] for e in every
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    lags = [e["ts"] - launches[e["args"]["correlation"]] for e in events
            if e.get("args", {}).get("correlation") in launches]
    first = min(launches.values(), default=None)
    return {"kernel": sum(name in e.get("name", "") for e in events),
            "mul": sum("mul" in e.get("name", "").lower() for e in events),
            "all_kernels": len(events), "rows_with_device_time": rows, "launch_calls":
            len(launches), "first_kernel_after_first_launch_us":
            None if not events or first is None else min(e["ts"] for e in events) - first,
            "least_lag_us": min(lags, default=None)}


def _unguarded(logdir, filename="trace.json"):
    """``utils.profiling.trace`` without the spin kernels that open it."""
    from xfmamba_tpu_torch.utils import profiling
    return profiling.trace(logdir, filename, edge=0)


@contextlib.contextmanager
def _edge_trace(logdir, filename="trace.json", guard_s=0.1):
    """``utils.profiling.trace`` with a one-element operation on the card,
    then ``guard_s`` of idle time, at each edge of the block: the second
    repair tried."""
    from torch.profiler import ProfilerActivity, profile

    def edge():
        torch.ones(1, device="cuda").add_(1.0)
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        edge()
        time.sleep(guard_s)
        yield prof
        torch.cuda.synchronize()
        time.sleep(guard_s)
        edge()
    prof.export_chrome_trace(os.path.join(logdir, filename))


def run_heavy() -> dict:
    """A long profile of three float32 XFMamba-S train steps at bs 16 (as
    phase 7f's), then HEAVY_ROUNDS rounds of the trace without and with the
    guard, in turns."""
    from torch.profiler import ProfilerActivity, profile
    from xfmamba_tpu_torch.kernels import build
    from xfmamba_tpu_torch.models.tops import two_view_xfmamba
    from xfmamba_tpu_torch.train import loop
    from xfmamba_tpu_torch.train.config import TrainConfig
    build.library()
    x = torch.ones(1 << 20, device="cuda")
    call = _traced_calls()
    model = two_view_xfmamba("small", seed=0)
    step, _ = loop.make_train_step(model, loop.make_optimizer(TrainConfig(), model.parameters()),
                                   multilabel=False)
    g = torch.Generator().manual_seed(1)
    batch = {"image1": torch.randn(16, 224, 224, 1, generator=g).cuda(),
             "image2": torch.randn(16, 224, 224, 1, generator=g).cuda(),
             "label": torch.zeros(16, dtype=torch.long).cuda()}
    step(batch)
    torch.cuda.synchronize()
    out = {"before": _trace_counts(call, "device_preprocess", x, _unguarded)}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            step(batch)
        torch.cuda.synchronize()
    rounds = []
    for _ in range(HEAVY_ROUNDS):
        rounds.append({"no_guard": _trace_counts(call, "device_preprocess", x, _unguarded),
                       "guard": _trace_counts(call, "device_preprocess", x, _sleep_trace)})
    out["after_long_profile"] = rounds
    return out


def _variants(call, x) -> dict:
    """The trace of `_trace_counts` six ways, one after another: without the
    spin kernels (``plain``); with idle time alone around the block
    (``sleep``); right after a throw-away profile of one ``mul``
    (``primed``); after PREFIX launches of a one-element ``add_`` inside the
    profile (``prefix``); with an operation and idle time at each edge
    (``edges``); ``utils.profiling.trace`` as it is (``trace``)."""
    from torch.profiler import ProfilerActivity, profile
    out = {"plain": _trace_counts(call, "device_preprocess", x, _unguarded),
           "sleep": _trace_counts(call, "device_preprocess", x, _sleep_trace)}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        x.mul(2.0)
        torch.cuda.synchronize()
    out["primed"] = _trace_counts(call, "device_preprocess", x, _unguarded)
    one = torch.zeros(1, device="cuda")
    state = {"done": False}

    def prefixed():
        if not state["done"]:
            for _ in range(PREFIX):
                one.add_(0.0)
            state["done"] = True
        call()
    out["prefix"] = _trace_counts(prefixed, "device_preprocess", x, _unguarded)
    out["edges"] = _trace_counts(call, "device_preprocess", x, _edge_trace)
    out["trace"] = _trace_counts(call, "device_preprocess", x)
    return {k: (v["kernel"], v["mul"], v["least_lag_us"]) for k, v in out.items()}


def run_degrade(seconds: float = 150.0) -> int:
    """Eager launches, then CUDA-graph replays (as chip_smoke's graph
    timings), for ``seconds`` each, with `_variants` of the trace every 15 s."""
    from xfmamba_tpu_torch.kernels import build
    build.library()
    x = torch.ones(1 << 20, device="cuda")
    call = _traced_calls()
    t0 = time.time()
    for mode in ("eager", "graphs"):
        end, last = time.time() + seconds, 0.0
        graph = None
        if mode == "graphs":
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                call()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                for _ in range(50):
                    call()
                    x.mul(2.0)
            torch.cuda.current_stream().wait_stream(side)
        while time.time() < end:
            for _ in range(20):
                if graph is None:
                    for _ in range(50):
                        call()
                        x.mul(2.0)
                else:
                    graph.replay()
            torch.cuda.synchronize()
            if time.time() - last > 15:
                last = time.time()
                print("DEGRADE " + json.dumps({"mode": mode, "s": round(time.time() - t0, 1),
                                               **_variants(call, x)}), flush=True)
    return 0


def run_smoke() -> int:
    """chip_smoke.main with the trace after every phase."""
    import functools
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import chip_smoke
    state = {}

    def traced(name, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            try:
                return fn(*args, **kw)
            finally:
                if "call" not in state:
                    state["x"] = torch.ones(1 << 20, device="cuda")
                    state["call"] = _traced_calls()
                t0 = time.time()
                counts = _trace_counts(state["call"], "device_preprocess", state["x"],
                                       _unguarded)
                counts["guarded"] = _trace_counts(state["call"], "device_preprocess",
                                                  state["x"], _sleep_trace)
                print("TRACE " + json.dumps({"after": name, **counts,
                                             "s": round(time.time() - t0, 2)}), flush=True)
        return wrapper

    for name in dir(chip_smoke):
        if name.startswith("phase_"):
            setattr(chip_smoke, name, traced(name, getattr(chip_smoke, name)))
    return chip_smoke.main()


def main(argv) -> int:
    if argv == ["--smoke"]:
        return run_smoke()
    if argv == ["--degrade"]:
        return run_degrade()
    if argv == ["--heavy"]:
        print(json.dumps(run_heavy()))
        return 0
    if len(argv) == 2:
        print(json.dumps(run_case(*argv)))
        return 0
    failed = 0
    for link in ("none", "static", "shared"):
        for before in BEFORE:
            proc = subprocess.run([sys.executable, "-m", __spec__.name, link, before],
                                  capture_output=True, text=True)
            line = proc.stdout.strip().splitlines()[-1:] or [""]
            print(line[0] if proc.returncode == 0 else
                  f"{link} {before}: rc {proc.returncode}\n{proc.stderr[-2000:]}", flush=True)
            failed += proc.returncode != 0
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "gloo.json")
        torch.multiprocessing.spawn(_gloo_rank, args=(port, out), nprocs=2)
        with open(out) as f:
            print(json.dumps({"gloo_on_cuda": json.load(f)}))
    print(json.dumps(_nccl_one()))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
