"""The PyTorch port imports no JAX, builds nothing at import time, and
decides about CUDA only when a kernel is launched."""

import inspect
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from xfmamba_tpu_torch.kernels import build
from xfmamba_tpu_torch.models.tops import two_view_xfmamba
from xfmamba_tpu_torch.models.vssm import vmamba_tiny_m2
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax_and_builds_nothing():
    code = (
        "import importlib, pkgutil, sys, xfmamba_tpu_torch\n"
        "for m in pkgutil.walk_packages(xfmamba_tpu_torch.__path__, 'xfmamba_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'xfmamba_tpu', 'PIL', 'cv2', 'pandas', "
        "'sklearn', 'torchvision', 'pydicom'))\n"
        "assert not bad, bad\n"
        "for m in ('train.config', 'train.loop', 'ops.vss_block_train', 'ops.vss_stage_train',\n"
        "          'ops.nk_scan_adjoint', 'ops.ss2d_core_n1', 'ops.selective_scan_grouped',\n"
        "          'ops.cross_scan', 'ops.ssd', 'ops.ssd_chunk', 'ops.vss_block_v1',\n"
        "          'ops.nk_scan_v1', 'ops.fused_cross_scan', 'ops.ablations.nk_scan_v4',\n"
        "          'ops.ablations.nk_scan_wide', 'ops.ablations.pe_fused', 'ops.ablations.seg_ln',\n"
        "          'ops.cross2d_scan', 'train.metrics', 'train.driver', 'checkpoint.io',\n"
        "          'utils.misc', 'native', 'data', 'data.loader', 'data.png', 'data.transforms',\n"
        "          'data.mura', 'data.jpeg', 'data.image', 'data.dicom', 'data.chexpert',\n"
        "          'data.hipxray', 'data.ddsm', 'data.nyu_cropping', 'data.optimal_centers',\n"
        "          'utils.profiling', 'cli', 'cli.train', 'cli.infer_mura', 'cli.infer_chexpert',\n"
        "          'cli.infer_ddsm'):\n"
        "    assert 'xfmamba_tpu_torch.' + m in sys.modules, m\n"
        "from xfmamba_tpu_torch.kernels import build\n"
        "assert build.library.cache_info().currsize == 0\n"
        "from xfmamba_tpu_torch import native\n"
        "assert native._library.cache_info().currsize == 0\n"
        "print('ok', len([n for n in sys.modules if n.startswith('xfmamba_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=False)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_library_name_is_keyed_on_the_sources():
    path = build.library_path()
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libxfm_") and path.suffix == ".so"
    assert build.library_path() == path
    assert {p.name for p in build._sources()} == {
        "gemm_tc.cu", "grouped_scan_lanes.cu", "ln_act.cu", "ln_act_v1.cu", "nk_scan.cu", "nk_scan_ablations.cu",
        "nk_scan_ablations_v1.cu", "nk_scan_adjoint.cu", "nk_scan_bwd.cu", "nk_scan_fused.cu", "scan_two_level.cu",
        "scan_whole_map.cu",
        "selective_scan_grouped_v1.cu", "ss2d_core_n1.cu", "ss2d_core_n1_v1.cu", "ssd_chunk.cu",
        "ssd_serial.cu", "vss_block_bwd.cu", "vss_block_v1.cu", "vss_stage.cu"}


def test_factory_is_seeded_and_eval():
    kw = dict(backbone_overrides=dict(depths=(1, 1, 1, 1), dims=8))
    a = two_view_xfmamba("tiny", seed=3, device="cpu", **kw)
    b = two_view_xfmamba("tiny", seed=3, device="cpu", **kw)
    assert not a.training
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_factory_defaults_to_the_card():
    """Without a device argument the model goes to CUDA: here, with no card,
    that raises instead of falling back to the CPU."""
    assert inspect.signature(two_view_xfmamba).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            two_view_xfmamba("tiny", backbone_overrides=dict(depths=(1, 1, 1, 1), dims=8))


def test_m2_factory_defaults_to_the_card():
    """The same for the Mamba-2 classifier factories."""
    assert inspect.signature(vmamba_tiny_m2).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            vmamba_tiny_m2(depths=(1, 1, 1, 1), dims=16)


BANNED = {"jax", "jaxlib", "flax", "optax", "xfmamba_tpu", "PIL", "cv2", "pandas", "sklearn",
          "torchvision", "pydicom"}


def test_no_source_imports_jax_or_the_missing_packages():
    """No module of the port, nor ``chip_smoke.py`` and the synthetic-tree
    helpers it runs, imports JAX, the JAX package, or a package that the
    machine with the card lacks (PIL, cv2, pandas, sklearn, torchvision,
    pydicom), not even inside a function."""
    import ast
    files = sorted((REPO / "xfmamba_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "torch_mura_tree.py",
        REPO / "tests" / "torch_datasets_tree.py"]
    found = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            found += [(path.name, n) for n in names if n.split(".")[0] in BANNED]
    assert not found, found
    assert len(files) > 50
