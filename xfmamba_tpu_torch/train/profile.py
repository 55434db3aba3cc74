"""Device-time profile of XFMamba-S training steps on one GPU.

    python -m xfmamba_tpu_torch.train.profile

Runs the train step of ``chip_smoke.py`` phase 7 (XFMamba-S, two views at
224x224, batch 16, bfloat16 activations, float32 weights, Adam at lr 1e-4
and weight decay 1e-5, the same seeds): 3 warm-up steps, then 2 steps
under ``torch.profiler``.  Prints per step the wall time (CUDA events), the
device time summed over the device-only rows (kernels and copies), their
ratio (the busy share; one stream, so kernels do not overlap), and the 25
device rows with the most time, with their calls per step.
"""

from __future__ import annotations

import torch

IMAGE, BATCH = 224, 16
WARMUP, STEPS, TOP = 3, 2, 25


def _device_us(row) -> float:
    return getattr(row, "self_device_time_total", None) or getattr(row, "self_cuda_time_total", 0.0)


def main() -> None:
    from torch.profiler import ProfilerActivity, profile

    from xfmamba_tpu_torch.models.tops import two_view_xfmamba
    from xfmamba_tpu_torch.train.config import TrainConfig
    from xfmamba_tpu_torch.train.loop import make_optimizer, make_train_step

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    model = two_view_xfmamba("small", device="cuda", seed=0)
    optimizer = make_optimizer(TrainConfig(lr=1e-4, weight_decay=1e-5), model.parameters())
    step, _ = make_train_step(model, optimizer, multilabel=False)
    g = torch.Generator().manual_seed(16)
    xa, xb = (torch.randn(BATCH, IMAGE, IMAGE, 1, generator=g).to("cuda", torch.bfloat16)
              for _ in range(2))
    batch = {"image1": xa, "image2": xb,
             "label": torch.zeros(BATCH, dtype=torch.long, device="cuda")}
    for _ in range(WARMUP):
        step(batch)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(STEPS):
            step(batch)
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end) / STEPS
    # device-only rows: kernels and copies; a user annotation's device row
    # spans kernels already counted
    rows = [r for r in prof.key_averages() if r.self_cpu_time_total == 0 and _device_us(r) > 0
            and not getattr(r, "is_user_annotation", False)]
    rows.sort(key=_device_us, reverse=True)
    busy = sum(map(_device_us, rows)) / 1e3 / STEPS
    print(f"PROFILE wall {wall:.3f} ms/step, device {busy:.3f} ms/step, "
          f"busy share {busy / wall:.3f} (bs {BATCH}, {torch.cuda.get_device_name(0)})")
    for r in rows[:TOP]:
        print(f"PROFILE {_device_us(r) / 1e3 / STEPS:10.3f} ms/step "
              f"{r.count / STEPS:7.1f} calls/step  {r.key[:110]}")


if __name__ == "__main__":
    main()
