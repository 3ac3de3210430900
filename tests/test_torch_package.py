"""Package rules of the PyTorch port (``src/repro_torch``).

* No module imports ``jax`` or the JAX package ``repro``: the port stands
  alone (only these tests import both); nor do ``chip_smoke.py``, the
  card tools under ``tools/`` and the port's training and routed-serving
  examples.
* Without a CUDA card ``default_device()`` raises and names the
  ``device="cpu"`` opt-in: there is no silent CPU fallback.
* CPU tensors run the plain versions and never count a kernel launch;
  tensors on another device raise.
* Importing the package builds nothing (kernels compile on first launch);
  a built library goes stale when its source or a shared header
  (``csrc/*.cuh``) is newer.
"""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import kernels
from repro_torch.core import draws
from repro_torch.kernels import _build

PKG = Path(repro_torch.__file__).resolve().parent


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 15
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: {mod}"


@pytest.mark.parametrize("script", ["chip_smoke.py", "tools/ab_kernels.py",
                                    "tools/kernel_phases.py",
                                    "tools/score_sweep.py",
                                    "examples/train_encoder_e2e_torch.py",
                                    "examples/routed_serving_e2e_torch.py",
                                    "examples/quickstart_torch.py",
                                    "examples/"
                                    "mixinstruct_preferences_torch.py",
                                    "tools/bwd_variants.py",
                                    "tools/fill_variants.py",
                                    "tools/bwd_sm90_variants.py",
                                    "tools/capture_after_profile.py",
                                    "tools/scan_bwd_variants.py",
                                    "tools/ssd_bwd_variants.py",
                                    "tools/variant_build.py",
                                    "tools/capture_gc.py"])
def test_card_scripts_import_neither_jax_nor_reference(script):
    """The scripts that run the port on the card import no JAX either: the
    machine with the card has none."""
    for mod in _imports(PKG.parents[1] / script):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), mod


def test_kernel_sources_present_for_every_library():
    for name in _build.SIGNATURES:
        assert (_build.CSRC / f"{name}.cu").is_file()


@pytest.mark.parametrize("touched", ["source", "header", "nothing", "none"])
def test_library_is_stale_when_source_or_header_is_newer(tmp_path,
                                                         monkeypatch,
                                                         touched):
    """``_stale`` on a temporary source and build directory: a library
    older than its ``.cu`` or than any ``.cuh`` beside it is rebuilt; one
    newer than both is reused; a missing one is built."""
    import os
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    src, hdr = csrc / "k.cu", csrc / "sm90.cuh"
    src.write_text("// kernel\n")
    hdr.write_text("// header\n")
    (csrc / "other.cu").write_text("// another library's source\n")
    os.utime(src, (1000, 1000))
    os.utime(hdr, (1000, 1000))
    os.utime(csrc / "other.cu", (5000, 5000))
    if touched != "none":
        lib = build / "libk.so"
        lib.write_bytes(b"")
        os.utime(lib, (2000, 2000))
    if touched == "source":
        os.utime(src, (3000, 3000))
    elif touched == "header":
        os.utime(hdr, (3000, 3000))
    assert _build._stale("k") == (touched != "nothing")


def test_default_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        repro_torch.default_device()
    with pytest.raises(RuntimeError):
        draws.TorchDraws(0)
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


def test_cpu_tensors_leave_launch_counters_at_zero():
    from repro_torch.core import env, fgts, policy
    kernels.reset_launch_counts()
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    cfg = fgts.FGTSConfig(n_models=4, dim=8, horizon=8, sgld_steps=2,
                          sgld_minibatch=4)
    envd = env.EnvData(
        torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32)),
        torch.from_numpy(rng.random((8, 4)).astype(np.float32)))
    env.run(draws.HostDraws(0), envd, policy.fgts_policy(a, cfg), batch=2,
            aux_fn=lambda s, a1, a2: fgts.chain_energy(s, a, cfg))
    assert kernels.launch_counts() == {k: 0 for k in kernels.WRAPPERS}


def test_other_devices_raise():
    x = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        kernels.dueling_select(x, torch.zeros((3, 4), device="meta"),
                               torch.zeros((2, 4), device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        kernels.potential_rows(
            torch.zeros((1, 4), device="meta"), x, None, None, None, None,
            None, None, None, j=1, eta=1.0, mu=0.2)
    with pytest.raises(ValueError, match="cpu or cuda"):
        kernels.posterior_scores(torch.zeros((3, 4), device="meta"),
                                 torch.zeros((2, 4), device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        kernels.WRAPPERS["flash_attention"](
            torch.zeros((1, 1, 2, 32), device="meta"),
            torch.zeros((1, 1, 2, 32), device="meta"),
            torch.zeros((1, 1, 2, 32), device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        kernels.mixed_potential_grad_rows(
            torch.zeros((1, 4), device="meta"), x, None, None, None, None,
            None, None, None, eta=1.0)


def test_import_builds_nothing(tmp_path):
    """A fresh interpreter imports every module without compiling or
    loading a kernel library."""
    code = (
        "import repro_torch, repro_torch.convert, repro_torch.core.env\n"
        "import repro_torch.data.pipeline, repro_torch.checkpoint\n"
        "import repro_torch.models.lm, repro_torch.configs\n"
        "from repro_torch.kernels import _build\n"
        "import sys\n"
        "assert _build._libs == {}, _build._libs\n"
        "assert 'triton' not in sys.modules\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=120,
                         env={"PYTHONPATH": str(PKG.parent),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_scaled_index_stays_in_range():
    u = torch.tensor([0.0, 0.5, 0.99999994])
    idx = draws.scaled_index(u, torch.tensor(7, dtype=torch.int32))
    assert idx.tolist() == [0, 3, 6]
    host = draws.HostDraws(3)
    a = host.randint((100,), 0, 5, "cpu")
    assert a.dtype == torch.int64 and int(a.min()) >= 0 and int(a.max()) < 5


@pytest.mark.parametrize("src", ["host", "torch"])
def test_sequential_sources_draw_randint_and_weighted_choice(src):
    """``randint`` stays in [lo, hi) (hi a 0-d tensor too) and reaches both
    ends; ``choice`` never draws a zero-weight index and follows the
    weights (4000 draws, within 0.05 of each probability)."""
    d = draws.HostDraws(2) if src == "host" else draws.TorchDraws(2, "cpu")
    a = d.randint((4000,), 3, torch.tensor(9), "cpu")
    assert a.dtype == torch.int64 and a.shape == (4000,)
    assert int(a.min()) == 3 and int(a.max()) == 8
    p = torch.tensor([0.5, 0.0, 0.2, 0.3])
    c = d.choice(4, (40, 100), p, "cpu")
    assert c.dtype == torch.int64 and c.shape == (40, 100)
    freq = torch.bincount(c.reshape(-1), minlength=4) / c.numel()
    assert int(freq[1] * c.numel()) == 0
    assert float((freq - p).abs().max()) < 0.05


@pytest.mark.parametrize("src", ["host", "torch"])
def test_sequential_sources_draw_gumbel_and_distinct_pairs(src):
    """Both standalone sources give Gumbel noise of the asked shape, a
    distinct in-range pair per row, and ``fold_in`` hands back a source
    (they ignore the key tree)."""
    d = draws.HostDraws(1) if src == "host" else draws.TorchDraws(1, "cpu")
    g = d.gumbel((3, 5), "cpu")
    assert g.shape == (3, 5) and g.dtype == torch.float32
    assert bool(torch.isfinite(g).all())
    pairs = d.fold_in(1).distinct_pair(400, 4, "cpu")
    assert pairs.shape == (400, 2) and pairs.dtype == torch.int64
    assert bool((pairs[:, 0] != pairs[:, 1]).all())
    assert int(pairs.min()) >= 0 and int(pairs.max()) < 4
    assert len({tuple(p) for p in pairs.tolist()}) == 12   # every ordered pair
