"""Device-time profile of XFMamba training steps on one GPU.

    python -m xfmamba_tpu_torch.train.profile [--dtype float32] [--forward] [--n1]

Runs the train step of ``chip_smoke.py`` phase 7 (XFMamba-S, two views at
224x224, batch 16, bfloat16 activations, float32 weights, Adam at lr 1e-4
and weight decay 1e-5, the same seeds; ``--dtype float32`` gives phase
7c's float32 step, TF32 off): 3 warm-up steps, then 2 steps under
``torch.profiler``; ``--forward`` then profiles a bs-32 forward of the
same model and dtype, and ``--n1`` kernels 11 and 12 alone (`n1_calls_fn`)
at the float32 bs-16 step's shapes.  Prints per step the wall time (CUDA
events), the device time summed over the device-only rows (kernels and
copies), their ratio (the busy share; one stream, so kernels do not
overlap), and the 25 device rows with the most time, with their calls per
step.  `profile_calls` does the same for any function (``chip_smoke.py``
also profiles a bs-32 bfloat16 forward with it).
"""

from __future__ import annotations

import argparse

import torch

IMAGE, BATCH = 224, 16
WARMUP, STEPS, TOP = 3, 2, 25


def _device_us(row) -> float:
    return getattr(row, "self_device_time_total", None) or getattr(row, "self_cuda_time_total", 0.0)


def profile_calls(fn, calls=STEPS, warmup=WARMUP):
    """(wall ms, device ms, [(device ms, calls, name)] by device time) per
    call of ``fn``: ``warmup`` calls, then ``calls`` under torch.profiler,
    wall from CUDA events, device the sum of the device-only rows."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
    # device-only rows: kernels and copies; a user annotation's device row
    # spans kernels already counted
    rows = [r for r in prof.key_averages() if r.self_cpu_time_total == 0 and _device_us(r) > 0
            and not getattr(r, "is_user_annotation", False)]
    rows.sort(key=_device_us, reverse=True)
    table = [(_device_us(r) / 1e3 / calls, r.count / calls, r.key) for r in rows]
    return start.elapsed_time(end) / calls, sum(ms for ms, _, _ in table), table


def print_profile(label, wall, busy, table, top=TOP):
    print(f"PROFILE {label}: wall {wall:.3f} ms, device {busy:.3f} ms, busy share "
          f"{busy / wall:.3f} ({torch.cuda.get_device_name(0)})")
    for ms, count, name in table[:top]:
        print(f"PROFILE {ms:10.3f} ms {count:7.1f} calls  {name[:110]}")


def train_step_fn(dtype=torch.bfloat16):
    """The phase-7 step (phase 7c's in float32) on its seeded model and
    batch, as a no-argument call."""
    from xfmamba_tpu_torch.models.tops import two_view_xfmamba
    from xfmamba_tpu_torch.train.config import TrainConfig
    from xfmamba_tpu_torch.train.loop import make_optimizer, make_train_step

    model = two_view_xfmamba("small", device="cuda", seed=0)
    optimizer = make_optimizer(TrainConfig(lr=1e-4, weight_decay=1e-5), model.parameters())
    step, _ = make_train_step(model, optimizer, multilabel=False)
    g = torch.Generator().manual_seed(16)
    xa, xb = (torch.randn(BATCH, IMAGE, IMAGE, 1, generator=g).to("cuda", dtype)
              for _ in range(2))
    batch = {"image1": xa, "image2": xb,
             "label": torch.zeros(BATCH, dtype=torch.long, device="cuda")}
    return lambda: step(batch)


def forward_fn(dtype=torch.bfloat16):
    """A no-gradient bs-32 two-view forward of the seeded model."""
    from xfmamba_tpu_torch.models.tops import two_view_xfmamba

    model = two_view_xfmamba("small", device="cuda", seed=0).eval()
    g = torch.Generator().manual_seed(32)
    xa, xb = (torch.randn(32, IMAGE, IMAGE, 1, generator=g).to("cuda", dtype)
              for _ in range(2))

    def run():
        with torch.no_grad():
            return model(xa, xb)
    return run


# each model's backbone stages: (H, d, depth); the N=1 core runs on D = 2d
# and dt rank R = ceil(d / 16)
STAGES = {"small": [(56, 96, 2), (28, 192, 2), (14, 384, 15), (7, 768, 2)],
          "base": [(56, 128, 2), (28, 256, 2), (14, 512, 15), (7, 1024, 2)]}


def n1_calls_fn(backward=False):
    """Kernel 11 (or 12, ``backward``) through its public wrapper at every
    stage of XFMamba-S as one float32 bs-16 step gives it (two views: 32
    images per call, each stage's call ``depth`` times), seeded operands,
    as a no-argument call; everything the wrapper launches (fills,
    products) is in it."""
    from xfmamba_tpu_torch.ops import ss2d_core_n1 as n1

    g = torch.Generator().manual_seed(8)
    dev = dict(device="cuda")
    calls = []
    for H, d, depth in STAGES["small"]:
        D, R = 2 * d, -(-d // 16)
        x = torch.randn(2 * BATCH, H, H, D, generator=g).to(**dev)
        xw = (torch.randn(4, R + 2, D, generator=g) * D ** -0.5).to(**dev)
        dtw = (torch.randn(4, D, R, generator=g) * R ** -0.5).to(**dev)
        bias = (0.5 * torch.randn(4, D, generator=g) - 4.0).to(**dev)
        A_logs = (1.5 * torch.rand(4 * D, 1, generator=g)).to(**dev)
        Ds = torch.randn(4 * D, generator=g).to(**dev)
        args = (x, *n1.pack_n1_inputs(x, xw, dtw, bias, A_logs, Ds))
        if backward:
            _, ck = n1.ss2d_core_n1_fwd(*args)
            gy = torch.randn(x.shape, generator=g).to(**dev)
            calls += [lambda a=args, c=ck, gy=gy: n1.ss2d_core_n1_bwd(*a, c, gy)] * depth
        else:
            calls += [lambda a=args: n1.ss2d_core_n1_fwd(*a)] * depth

    def run():
        with torch.no_grad():
            for call in calls:
                call()
    return run


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    parser.add_argument("--forward", action="store_true", help="also profile a bs-32 forward")
    parser.add_argument("--n1", action="store_true",
                        help="also profile kernels 11 and 12 alone at the float32 step's shapes")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, args.dtype)
    wall, busy, table = profile_calls(train_step_fn(dtype))
    print_profile(f"bs-{BATCH} {args.dtype} train step", wall, busy, table)
    if args.forward:
        wall, busy, table = profile_calls(forward_fn(dtype))
        print_profile(f"bs-32 {args.dtype} forward", wall, busy, table)
    if args.n1:
        for backward in (False, True):
            wall, busy, table = profile_calls(n1_calls_fn(backward))
            print_profile(f"kernel {12 if backward else 11} per float32 bs-{BATCH} step", wall,
                          busy, table)


if __name__ == "__main__":
    main()
