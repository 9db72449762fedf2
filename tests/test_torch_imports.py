"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package ``repro``, not even its JAX-free modules."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
SCANNED = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _port_modules() -> list:
    return sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", SCANNED,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_package_imports_with_jax_blocked():
    """Every port module imports in a process where ``import jax`` fails,
    and no ``repro`` module gets loaded along the way."""
    mods = _port_modules()
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "loaded = [m for m in sys.modules if m == 'repro' "
        "or m.startswith('repro.') or m.split('.')[0] in ('jax', 'jaxlib')"
        " and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok', len(" + repr(mods) + "))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_tensor_parallel_modules_are_covered():
    """The scan and the jax-blocked import above reach the tensor-parallel
    modules."""
    for rel in ("parallel/sharding.py", "parallel/mesh.py",
                "launch/mesh.py"):
        assert PORT / rel in SCANNED
    assert {"repro_torch.parallel.sharding", "repro_torch.parallel.mesh",
            "repro_torch.launch.mesh"} <= set(_port_modules())


def test_moe_modules_are_covered():
    """The scan and the jax-blocked import above reach the MoE slice's
    modules (the two configurations, the layers and kernels it extends)."""
    for rel in ("configs/moonshot_v1_16b_a3b.py",
                "configs/qwen3_moe_235b_a22b.py", "layers/mlp.py",
                "core/qlinear.py", "kernels/w4ax_matmul.py"):
        assert PORT / rel in SCANNED
    assert {"repro_torch.configs.moonshot_v1_16b_a3b",
            "repro_torch.configs.qwen3_moe_235b_a22b",
            "repro_torch.layers.mlp"} <= set(_port_modules())


def test_spawned_ranks_import_no_jax_or_repro():
    """Ranks started by ``launch.mesh.spawn`` (two gloo processes) import
    every port module and join their mesh without loading JAX or any
    ``repro`` module."""
    import _torch_tp_ranks as R
    from repro_torch.launch.mesh import spawn
    got = spawn(R.import_all, 2, (_port_modules(),), threads=1,
                timeout_s=120.0)
    assert got == [[], []]


def test_kernel_sources_present():
    """Every CUDA source the build names exists, and the launch counters
    start as plain integers on the wrappers."""
    from repro_torch.kernels import _build, ops
    for name in _build.SOURCES:
        assert (PORT / "csrc" / f"{name}.cu").is_file()
    assert set(ops.KERNELS) == {
        "act_quant_w4ax", "act_quant_int4", "act_quant_int8", "w4a4_matmul",
        "w4a8_matmul", "w4a4_matmul_experts", "w4a8_matmul_experts",
        "w4ax_matmul_mixed_experts",
        "w4ax_matmul_mixed", "paged_kv4_prefill_attention_wq",
        "paged_kv4_decode_attention",
        "paged_kv4_prefill_attention", "paged_kv4_decode_attention_wq",
        "kv4_decode_attention"}
    assert all(isinstance(k.launches, int) for k in ops.KERNELS.values())


def test_fmpq_and_model_forward_modules_are_covered():
    """The scan and the jax-blocked import above reach FMPQ and the
    modules of the model's own forward (the caches, K10's wrapper)."""
    for rel in ("core/fmpq.py", "core/quantizer.py", "core/qlinear.py",
                "layers/attention.py", "models/lm.py", "convert.py",
                "kernels/kv4_attention.py"):
        assert PORT / rel in SCANNED
    assert {"repro_torch.core.fmpq", "repro_torch.layers.attention",
            "repro_torch.models.lm", "repro_torch.convert"} <= set(
                _port_modules())


def test_other_family_modules_are_covered():
    """The scan and the jax-blocked import above reach the other
    families' modules (Mamba2, RWKV-6, their four configurations) and
    the files they extend (the model, attention, K10's wrapper)."""
    new = ("layers/mamba2.py", "layers/rwkv6.py", "configs/zamba2_2p7b.py",
           "configs/rwkv6_1p6b.py", "configs/llama3p2_vision_90b.py",
           "configs/hubert_xlarge.py")
    for rel in new + ("models/lm.py", "layers/attention.py", "convert.py",
                      "kernels/kv4_attention.py"):
        assert PORT / rel in SCANNED
    assert {"repro_torch." + r[:-3].replace("/", ".") for r in new} <= set(
        _port_modules())
