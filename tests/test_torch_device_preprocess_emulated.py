"""The CUDA source of the device preprocessing kernel
(``xfmamba_tpu_torch/csrc/device_preprocess.cu``) run on the CPU.

g++ compiles it against the stub CUDA headers of ``tests/cuda_emulator``
(one thread per CUDA thread; ``__fmul_rn`` and its kin each rounded once,
``__float2int_rn`` to nearest even), and the wrapper
(`ops.device_preprocess.device_preprocess`) calls it through ctypes on CPU
tensors.  It is held against the plain version bit for bit: every stage of
`data.device_pipeline` (MURA, CheXpert, CBIS-DDSM; train and eval), odd
sizes (staged 37 x 41, resized up and down, a crop window at each edge),
angles of ±30°, 90° and 0°, flips on and off; one launch a call; a rows
tensor that requires a gradient is refused before the launch, while
autograd records (the guard of every forward-only wrapper).
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from xfmamba_tpu_torch.data import device_pipeline as dp
from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.ops import device_preprocess as op
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

STUBS = Path(__file__).resolve().parent / "cuda_emulator"
SOURCE = "device_preprocess.cu"


def _rewrite(text):
    """Launches become ``emu_launch`` calls; the source reports the
    emulator's launch count."""
    text += '\nextern "C" int emu_launches() { return emu_launch_count; }\n'
    return re.sub(r"(\w+)\s*<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", text, flags=re.S)


def _check(status, what):
    if status != 0:
        raise RuntimeError(f"{what}: status {status}")


@pytest.fixture(scope="module")
def emulated():
    """The emulated library, built once into the port's build directory
    (keyed on the source and the stubs), bound as `build.library`, with the
    wrapper's CPU dispatch switched to the launch path."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    text = (build.CSRC_DIR / SOURCE).read_text()
    key = hashlib.sha256(text.encode() + b"".join(
        p.read_bytes() for p in sorted(STUBS.glob("*.h")))).hexdigest()[:16]
    out = build.BUILD_DIR / f"emulated_{key}"
    so = out / "libdevice_preprocess_emulated.so"
    if not so.exists():
        src = out / f"src.{os.getpid()}"
        src.mkdir(parents=True, exist_ok=True)
        (src / SOURCE).write_text(_rewrite(text))
        tmp = out / f"lib.{os.getpid()}.tmp"
        subprocess.run([gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-w",
                        "-include", "cstring", "-I", str(STUBS), "-x", "c++", str(src / SOURCE),
                        "-o", str(tmp)], check=True, capture_output=True, timeout=600)
        tmp.replace(so)
        shutil.rmtree(src, ignore_errors=True)
    lib = ctypes.CDLL(str(so))
    lib.xfm_device_preprocess.argtypes = build._SIGNATURES["xfm_device_preprocess"]
    lib.xfm_device_preprocess.restype = ctypes.c_int
    lib.emu_launches.restype = ctypes.c_int
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(build, "library", lambda: lib)
        mp.setattr(build, "check", _check)
        mp.setattr(op, "on_cpu", lambda *t: False)
        mp.setattr(op, "stream", lambda t: None)
        yield lib


def _u8(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8))


def _plain(stage, u8, rows):
    kw = {} if stage.normalize_mean is None else {"mean": stage.normalize_mean,
                                                  "std": stage.normalize_std}
    if rows is None:
        return op.device_preprocess_plain(u8, stage.image_size, **kw)
    return op.device_preprocess_plain(u8, stage.image_size, rows, stage.crop_size,
                                      bool(stage.rotation), **kw)


def _launch(emulated, call):
    before, dev = op.device_preprocess.launches, emulated.emu_launches()
    out = call()
    assert op.device_preprocess.launches == before + 1 and emulated.emu_launches() == dev + 1
    return out


STAGES = {
    "mura": dp.mura_device_preprocess,
    "chexpert": dp.chexpert_device_preprocess,
    "ddsm": dp.ddsm_device_preprocess,
}


# (staged size, image size): the resize the identity, up from a smaller
# staging and down from a larger one; odd sizes on both axes
GEOMETRIES = [((37, 41), (37, 41)), ((20, 23), (37, 41)), ((37, 41), (29, 33))]


@pytest.mark.parametrize("staged,size", GEOMETRIES)
@pytest.mark.parametrize("name", sorted(STAGES))
def test_emulated_eval_matches_plain(emulated, name, staged, size):
    """The eval transform (resize and normalize), bit for bit."""
    stage = STAGES[name](size, train=True)
    u8 = _u8((2,) + staged + (1,), 1)
    got = _launch(emulated, lambda: stage.eval_batch(u8))
    assert got.shape == (2,) + size + (1,) and got.dtype == torch.float32
    assert torch.equal(got, _plain(stage, u8, None))


# per sample: (top, left) as fractions of the free range (0 and 1 the
# windows at the edges), flip, angle in degrees
SAMPLES = [(0.0, 0.0, False, 30.0), (1.0, 1.0, True, -30.0), (0.0, 1.0, True, 90.0),
           (1.0, 0.0, False, 0.0), (0.5, 0.25, True, 17.3)]


def _params(stage, geometry_free):
    fh, fw = geometry_free
    top = torch.tensor([round(t * fh) for t, _, _, _ in SAMPLES])
    left = torch.tensor([round(l * fw) for _, l, _, _ in SAMPLES])
    flip = torch.tensor([f and stage.hflip for _, _, f, _ in SAMPLES])
    angle = torch.tensor([a if stage.rotation else 0.0 for *_, a in SAMPLES])
    return {"top": top, "left": left, "flip": flip, "angle": angle}


@pytest.mark.parametrize("staged,size,crop", [((37, 41), (37, 41), 31), ((20, 23), (37, 41), 29),
                                              ((37, 41), (29, 33), 224)])
@pytest.mark.parametrize("name", sorted(STAGES))
def test_emulated_train_matches_plain(emulated, name, staged, size, crop):
    """The train transform with crop windows at each edge, flips and the
    angles of `SAMPLES`, bit for bit; the crop clamps to the image as JAX's
    ``min(crop, *image_size)``."""
    stage = STAGES[name](size, train=True)
    if stage.crop:
        stage.crop = crop
    c = stage.crop_size
    h, w = (c, c) if c else size
    free = (size[0] - h, size[1] - w) if c else (0, 0)
    u8 = _u8((len(SAMPLES),) + staged + (1,), 2)
    rows = stage.rows(_params(stage, free))
    got = _launch(emulated, lambda: stage.train_batch(u8, rows))
    assert got.shape == (len(SAMPLES), h, w, 1)
    want = _plain(stage, u8, rows)
    assert torch.equal(got, want)
    again = stage.train_batch(u8, rows)
    assert torch.equal(got, again)


def test_emulated_rotation_indices_are_the_plain_ones(emulated):
    """A ramp whose value names its pixel: the kernel's source of every
    output pixel (or the zero fill) is the plain version's, at the four
    angles, flipped and not."""
    H, W = 37, 41
    stage = dp.DevicePreprocess(image_size=(H, W), crop=None, hflip=True, rotation=30.0,
                                normalize_mean=None, normalize_std=None)
    ramp = (torch.arange(H * W) % 251 + 1).to(torch.uint8).view(1, H, W, 1).repeat(8, 1, 1, 1)
    angle = torch.tensor([30.0, -30.0, 90.0, 0.0] * 2)
    flip = torch.tensor([False] * 4 + [True] * 4)
    rows = op.param_rows(torch.zeros(8), torch.zeros(8), flip, angle)
    got = _launch(emulated, lambda: stage.train_batch(ramp, rows))
    assert torch.equal(got, _plain(stage, ramp, rows))
    zero_fill = (got == 0).sum((1, 2, 3))
    assert zero_fill[3] == 0 and zero_fill[7] == 0 and zero_fill[0] > 0
    # 90° about the centre of an odd-by-odd window is an exact quarter turn
    # of its centred square (sx = -yy + cx, sy = xx + cy)
    sq = got[2, 2:35, 4:37, 0]
    want = torch.rot90(ramp[0, 2:35, 4:37, 0].float() / 255, 1)
    assert torch.equal(sq, want)


def test_emulated_guard_refuses_a_graph(emulated):
    """While autograd records, a rows tensor that requires a gradient is
    refused before the launch (the kernel has no backward); under
    ``torch.no_grad()`` the same call runs."""
    stage = dp.mura_device_preprocess((37, 41))
    u8 = _u8((2, 37, 41, 1), 3)
    rows = op.param_rows(torch.zeros(2), torch.zeros(2), torch.zeros(2), torch.zeros(2))
    rows.requires_grad_()
    before, dev = op.device_preprocess.launches, emulated.emu_launches()
    with pytest.raises(RuntimeError, match="no gradient"):
        stage.train_batch(u8, rows)
    assert op.device_preprocess.launches == before and emulated.emu_launches() == dev
    with torch.no_grad():
        got = _launch(emulated, lambda: stage.train_batch(u8, rows))
    assert torch.equal(got, _plain(stage, u8, rows.detach()))
