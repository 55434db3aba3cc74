"""Device-time profile of XFMamba-S training steps on one GPU.

    python -m xfmamba_tpu_torch.train.profile

Runs the train step of ``chip_smoke.py`` phase 7 (XFMamba-S, two views at
224x224, batch 16, bfloat16 activations, float32 weights, Adam at lr 1e-4
and weight decay 1e-5, the same seeds): 3 warm-up steps, then 2 steps
under ``torch.profiler``.  Prints per step the wall time (CUDA events), the
device time summed over the device-only rows (kernels and copies), their
ratio (the busy share; one stream, so kernels do not overlap), and the 25
device rows with the most time, with their calls per step.  `profile_calls`
does the same for any function (``chip_smoke.py`` also profiles a bs-32
bfloat16 forward with it).
"""

from __future__ import annotations

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


def train_step_fn():
    """The phase-7 step on its seeded model and batch, as a no-argument call."""
    from xfmamba_tpu_torch.models.tops import two_view_xfmamba
    from xfmamba_tpu_torch.train.config import TrainConfig
    from xfmamba_tpu_torch.train.loop import make_optimizer, make_train_step

    model = two_view_xfmamba("small", device="cuda", seed=0)
    optimizer = make_optimizer(TrainConfig(lr=1e-4, weight_decay=1e-5), model.parameters())
    step, _ = make_train_step(model, optimizer, multilabel=False)
    g = torch.Generator().manual_seed(16)
    xa, xb = (torch.randn(BATCH, IMAGE, IMAGE, 1, generator=g).to("cuda", torch.bfloat16)
              for _ in range(2))
    batch = {"image1": xa, "image2": xb,
             "label": torch.zeros(BATCH, dtype=torch.long, device="cuda")}
    return lambda: step(batch)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    wall, busy, table = profile_calls(train_step_fn())
    print_profile(f"bs-{BATCH} bfloat16 train step", wall, busy, table)


if __name__ == "__main__":
    main()
