"""The port (pipegcn_tpu_torch) and chip_smoke.py stand alone: they import
neither jax nor anything of pipegcn_tpu, and no entry point falls back to
the CPU when CUDA is missing."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from pipegcn_tpu_torch import device as port_device
from pipegcn_tpu_torch.cli import serve as port_cli
from pipegcn_tpu_torch.ops.spmm import spmm_mean
from pipegcn_tpu_torch.parallel.halo import halo_gather

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "pipegcn_tpu_torch")


def _port_files():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _forbidden(name: str) -> bool:
    return any(name == m or name.startswith(m + ".")
               for m in ("jax", "jaxlib", "pipegcn_tpu"))


def test_no_jax_import_statement_in_port():
    bad = []
    for path in _port_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(path, n) for n in names if _forbidden(n)]
    assert not bad, bad


def test_importing_every_port_module_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pipegcn_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'pipegcn_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'pipegcn_tpu') or m.startswith(('jax.', 'jaxlib.', "
        "'pipegcn_tpu.'))]\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 20 else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_cuda_and_no_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_device.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_device.resolve_device("cuda")
    assert port_device.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main(["--dataset", "karate", "--n-partitions", "2",
                       "--partition-dir", "unused-nonexistent",
                       "--serve-build"])


def test_wrappers_refuse_devices_without_a_kernel():
    # a tensor that is neither on the CPU (plain version) nor on CUDA
    # (the kernel) has no path: the wrappers raise instead of guessing
    m = torch.device("meta")
    fbuf = torch.empty((4, 3), device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        spmm_mean(fbuf, torch.zeros(3, dtype=torch.int32, device=m),
                  torch.zeros(5, dtype=torch.int32, device=m),
                  torch.ones(2, device=m))
    h = torch.empty((2, 4, 3), device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        halo_gather(h, torch.zeros((2, 1, 2), dtype=torch.int32, device=m),
                    torch.zeros((2, 1, 2), dtype=torch.bool, device=m),
                    with_inner=True)


@pytest.mark.parametrize("alone", [False, True],
                         ids=["in-repo", "script-alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No CUDA here: chip_smoke.py exits non-zero and prints no result —
    also when copied into a directory with nothing else of the repo."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        dst = tmp_path / "chip_smoke.py"
        dst.write_text(open(script).read())
        script, cwd = str(dst), str(tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout == ""


TRAINING_MODULES = ("pipegcn_tpu_torch.parallel.trainer",
                    "pipegcn_tpu_torch.cli.main", "pipegcn_tpu_torch.train",
                    "pipegcn_tpu_torch.train.losses",
                    "pipegcn_tpu_torch.train.optim",
                    "pipegcn_tpu_torch.train.metrics",
                    "pipegcn_tpu_torch.tree")


def test_training_modules_import_without_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {TRAINING_MODULES!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'pipegcn_tpu') or m.startswith(('jax.', 'jaxlib.', "
        "'pipegcn_tpu.'))]\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    for m in TRAINING_MODULES:
        path = os.path.join(ROOT, *m.split(".")) + ".py"
        if not os.path.exists(path):
            path = os.path.join(ROOT, *m.split("."), "__init__.py")
        assert path in set(_port_files()), m


def test_training_wrappers_refuse_devices_without_a_kernel():
    from pipegcn_tpu_torch.ops.spmm import spmm_mean_t
    from pipegcn_tpu_torch.parallel.halo import return_blocks, scatter_bgrad

    m = torch.device("meta")
    i32 = dict(dtype=torch.int32, device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        spmm_mean_t(torch.empty((2, 3), device=m), torch.zeros(5, **i32),
                    torch.zeros(4, **i32), torch.ones(2, device=m))
    with pytest.raises(ValueError, match="unsupported device"):
        return_blocks(torch.empty((2, 3, 4), device=m), 3)
    with pytest.raises(ValueError, match="unsupported device"):
        scatter_bgrad(torch.empty((2, 5, 4), device=m),
                      torch.empty((2, 3, 4), device=m),
                      torch.zeros((2, 6), **i32), torch.zeros((2, 3), **i32))


def test_training_cli_without_cuda_raises(monkeypatch):
    from pipegcn_tpu_torch.cli import main as train_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--dataset", "karate", "--n-partitions", "2"])


def test_model_family_modules_import_without_jax():
    code = (
        "import sys\n"
        "import pipegcn_tpu_torch.ops.gat, pipegcn_tpu_torch.models.sage\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'pipegcn_tpu') or m.startswith(('jax.', 'jaxlib.', "
        "'pipegcn_tpu.'))]\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert os.path.join(PKG, "ops", "gat.py") in set(_port_files())


def test_gat_wrappers_refuse_devices_without_a_kernel():
    from pipegcn_tpu_torch.ops import gat

    m = torch.device("meta")
    P, R, n, H, dh = 1, 5, 3, 2, 4
    z = torch.empty((P, R, H, dh), device=m)
    el = torch.empty((P, R, H), device=m)
    er = torch.empty((P, n, H), device=m)
    g = torch.empty((P, n, H, dh), device=m)
    ip = torch.zeros((P, n + 1), dtype=torch.int32, device=m)
    ip_t = torch.zeros((P, R + 1), dtype=torch.int32, device=m)
    idx = torch.zeros((P, 4), dtype=torch.int32, device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        gat.gat_attention(z, el, er, ip, idx)
    with pytest.raises(ValueError, match="unsupported device"):
        gat.gat_fwd(z, el, er, ip, idx, neg=True)
    with pytest.raises(ValueError, match="unsupported device"):
        gat.gat_bwd_src(z, el, er, er, er, g, er, ip_t, idx)


def test_bucket_wrappers_refuse_devices_without_a_kernel():
    import pipegcn_tpu_torch.ops.bucket_spmm as bs

    m = torch.device("meta")
    side = bs.BucketSide(idx=torch.zeros((2, 6), dtype=torch.int32, device=m),
                         inv=torch.zeros((2, 3), dtype=torch.int32, device=m),
                         meta=torch.zeros((3, 2), dtype=torch.int64,
                                          device=m),
                         n_src=5, widths=(2,))
    x = torch.empty((2, 5, 4), device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        bs.bucket_gather(x, side)
    with pytest.raises(ValueError, match="unsupported device"):
        bs.transport_cast(x, torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="unsupported device"):
        bs.part_amax(x)


def test_bucket_modules_import_without_jax():
    code = (
        "import sys\n"
        "import pipegcn_tpu_torch.ops.bucket_spmm\n"
        "import pipegcn_tpu_torch.parallel.staging\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'pipegcn_tpu') or m.startswith(('jax.', 'jaxlib.', "
        "'pipegcn_tpu.'))]\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert os.path.join(PKG, "ops", "bucket_spmm.py") in set(_port_files())


def test_block_modules_import_without_jax():
    code = (
        "import sys\n"
        "import pipegcn_tpu_torch.ops.block_spmm\n"
        "import pipegcn_tpu_torch.partition.partitioner\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'pipegcn_tpu', 'ml_dtypes') or m.startswith(('jax.', 'jaxlib.', "
        "'pipegcn_tpu.'))]\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    for rel in (("ops", "block_spmm.py"), ("ops", "csrc", "block_spmm.cu")):
        assert os.path.exists(os.path.join(PKG, *rel)), rel
    assert os.path.join(PKG, "ops", "block_spmm.py") in set(_port_files())


def test_block_wrappers_refuse_devices_without_a_kernel():
    from pipegcn_tpu_torch.ops import block_spmm as blk
    from pipegcn_tpu_torch.ops.bucket_spmm import BucketSide

    m = torch.device("meta")
    P, n, R, T = 1, 40, 64, 32
    i32 = dict(dtype=torch.int32, device=m)

    def side(n_out, n_in, tr):
        return blk.BlockSide(ptr=torch.zeros((P, -(-n_out // T) + 1), **i32),
                             blk=torch.zeros((P, 1), **i32),
                             tile=torch.zeros((P, 1), **i32), n_out=n_out,
                             n_in=n_in, transpose=tr)

    rem = BucketSide(idx=torch.zeros((P, 1), **i32),
                     inv=torch.zeros((P, n), **i32),
                     meta=torch.zeros((3, 2), dtype=torch.int64, device=m),
                     n_src=R, widths=(1,))
    t = blk.BlockTables(a=torch.zeros((P, 1, T, T // 8), dtype=torch.uint8,
                                      device=m), packed=True, tile=T,
                        fwd=side(n, R, False), bwd=side(R, n, True),
                        rem_fwd=rem, rem_bwd=rem)
    with pytest.raises(ValueError, match="unsupported device"):
        blk.block_dense(torch.empty((P, R, 3), device=m), t)
    with pytest.raises(ValueError, match="unsupported device"):
        blk.block_dense_t(torch.empty((P, n, 3), device=m), t)


def test_native_module_is_the_ports_own():
    """pipegcn_tpu_torch.native builds and loads its own copy of the C++
    sources (into the git-ignored build/ directory, never into a package
    directory), and using it (a partition, a radix sort) loads neither jax
    nor anything of pipegcn_tpu."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from pipegcn_tpu_torch import native\n"
        "from pipegcn_tpu_torch.graph.synthetic import synthetic_graph\n"
        "from pipegcn_tpu_torch.partition.partitioner import "
        "partition_graph\n"
        "assert native.available()\n"
        "p = native.lib_path()\n"
        "assert p.parent.name == 'native' and p.parent.parent.name == "
        "'build', p\n"
        "g = synthetic_graph(num_nodes=500, avg_degree=6)\n"
        "assert partition_graph(g, 2).shape == (500,)\n"
        "k = np.arange(2**20)[::-1].copy()\n"
        "assert (native.stable_argsort(k) == k).all()\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'pipegcn_tpu') or m.startswith(('jax.', 'jaxlib.', "
        "'pipegcn_tpu.'))]\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    native_dir = os.path.join(PKG, "native")
    assert sorted(f for f in os.listdir(native_dir)
                  if f.endswith(".cpp")) == ["halo_builder.cpp",
                                             "partitioner.cpp"]
    assert not [f for f in os.listdir(native_dir) if f.endswith(".so")]


def test_wire_and_grouped_wrappers_refuse_devices_without_a_kernel():
    """K14 / K15 (the halo wire) and K16 / K17 (the union-gather tile
    products): a tensor neither on the CPU nor on CUDA raises."""
    from pipegcn_tpu_torch.ops import block_spmm as blk
    from pipegcn_tpu_torch.parallel.halo import halo_amax, halo_wire

    m = torch.device("meta")
    h = torch.empty((2, 5, 4), device=m)
    idx = torch.zeros((2, 1, 3), dtype=torch.int32, device=m)
    mask = torch.zeros((2, 1, 3), dtype=torch.bool, device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        halo_amax(h, idx, mask, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        halo_wire(h, idx, mask, 3, torch.bfloat16)
    i32 = dict(dtype=torch.int32, device=m)
    side = blk.GroupSide(ptr=torch.zeros((1, 2), **i32),
                         tile=torch.zeros((1, 1), **i32),
                         blk=torch.zeros((1, 1, 2), **i32), group=2,
                         n_out=64, n_in=64, n_out_tiles=2, transpose=False)
    tables = blk.BlockTables(
        a=torch.zeros((1, 1, 32, 4), dtype=torch.uint8, device=m),
        packed=True, tile=32, fwd=side,
        bwd=blk.GroupSide(**{**side.__dict__, "transpose": True}),
        rem_fwd=None, rem_bwd=None)
    x = torch.empty((1, 64, 8), device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        blk.block_dense_grouped(x, tables)
    with pytest.raises(ValueError, match="unsupported device"):
        blk.block_dense_grouped_t(x, tables)


def test_freshness_modules_import_without_jax():
    code = (
        "import sys\n"
        "import pipegcn_tpu_torch.serve.freshness\n"
        "import pipegcn_tpu_torch.serve.cache\n"
        "import pipegcn_tpu_torch.serve.engine\n"
        "import pipegcn_tpu_torch.serve.loadgen\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'pipegcn_tpu') or m.startswith(('jax.', 'jaxlib.', "
        "'pipegcn_tpu.'))]\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    for rel in (("serve", "freshness.py"), ("serve", "cache.py")):
        assert os.path.join(PKG, *rel) in set(_port_files()), rel


def test_dirty_exchange_refuses_devices_without_a_kernel():
    """K18 (the dirty-row exchange): a tensor neither on the CPU nor on
    CUDA raises."""
    from pipegcn_tpu_torch.serve.freshness import dirty_exchange

    m = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dirty_exchange(torch.empty((2, 5, 4), device=m),
                       torch.empty((2, 3, 4), device=m),
                       torch.zeros((2, 5), dtype=torch.bool, device=m),
                       torch.zeros((2, 1, 3), dtype=torch.int32, device=m),
                       torch.zeros((2, 1, 3), dtype=torch.bool, device=m))


def test_integrity_modules_import_without_jax():
    code = (
        "import sys\n"
        "import pipegcn_tpu_torch.ops.digest\n"
        "import pipegcn_tpu_torch.resilience.integrity\n"
        "import pipegcn_tpu_torch.resilience.faults\n"
        "import pipegcn_tpu_torch.obs.metrics\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'pipegcn_tpu', 'ml_dtypes') or m.startswith(('jax.', 'jaxlib.', "
        "'pipegcn_tpu.'))]\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    files = set(_port_files())
    for rel in (("ops", "digest.py"), ("resilience", "integrity.py"),
                ("resilience", "faults.py"), ("resilience", "__init__.py"),
                ("obs", "metrics.py"), ("obs", "__init__.py")):
        assert os.path.join(PKG, *rel) in files, rel
    assert os.path.exists(os.path.join(PKG, "ops", "csrc", "digest.cu"))


def test_digest_wrappers_refuse_devices_without_a_kernel():
    """K19 (the integrity plane's digests, every form): a tensor neither
    on the CPU nor on CUDA raises."""
    from pipegcn_tpu_torch.ops import digest

    m = torch.device("meta")
    x = torch.empty((2, 5, 4), device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        digest.digest(x)
    with pytest.raises(ValueError, match="unsupported device"):
        digest.part_digests(x)
    with pytest.raises(ValueError, match="unsupported device"):
        digest.row_sums(x, torch.zeros((2, 1, 3), dtype=torch.int32,
                                       device=m),
                        torch.zeros((2, 1, 3), dtype=torch.bool, device=m))
