"""The PyTorch port stands alone: no module of
``neuronx_distributed_llama3_2_tpu_torch`` and nothing in ``chip_smoke.py``
imports JAX or the JAX package. Top-level module names are compared
exactly — the port's own name starts with the JAX package's."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "neuronx_distributed_llama3_2_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "neuronx_distributed_llama3_2_tpu"}
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_top_levels(path: Path):
    """Top-level module names of every import statement in ``path``,
    nested imports (inside functions) included."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_sources_exist():
    assert (ROOT / "chip_smoke.py").is_file()
    assert len(SOURCES) > 10
    # every subpackage is scanned, the quantization one included
    for sub in ("inference", "kernels", "models", "quantization", "serving", "trainer"):
        assert PORT / sub / "__init__.py" in SOURCES
    assert PORT / "quantization" / "kv_cache.py" in SOURCES
    # the SLO-aware scheduler and the front door
    assert PORT / "serving" / "scheduler.py" in SOURCES
    assert PORT / "serving" / "server.py" in SOURCES
    # the dense engine's modules and the generate script
    for mod in ("benchmark.py", "runner.py", "medusa.py", "engine.py", "speculative.py"):
        assert PORT / "inference" / mod in SOURCES
    assert PORT / "scripts" / "__init__.py" in SOURCES
    assert PORT / "scripts" / "generate.py" in SOURCES
    # data and checkpoint, TensorBoard, the profiler, the pretrain script
    for sub, mods in (("checkpoint", ("__init__.py", "storage.py", "checkpoint.py")),
                      ("data", ("__init__.py", "dataset.py", "native_loader.py")),
                      ("trainer", ("tensorboard.py",)), ("utils", ("profiler.py",)),
                      ("scripts", ("pretrain.py",))):
        for mod in mods:
            assert PORT / sub / mod in SOURCES, (sub, mod)
    # the pipeline: the schedules and the stage executor
    for mod in ("__init__.py", "scheduler.py", "model.py"):
        assert PORT / "pipeline" / mod in SOURCES, mod
    # MoE and quantized layers: the moe package, the MoE families, the
    # weight quantization
    for mod in ("__init__.py", "routing.py", "experts.py", "model.py", "loss.py"):
        assert PORT / "moe" / mod in SOURCES, mod
    for mod in ("mixtral.py", "dbrx.py"):
        assert PORT / "models" / mod in SOURCES, mod
    for mod in ("quantize.py", "layers.py"):
        assert PORT / "quantization" / mod in SOURCES, mod
    # LoRA, the GPT-NeoX / CodeGen and BERT families, the model registry
    for mod in ("__init__.py", "model.py"):
        assert PORT / "lora" / mod in SOURCES, mod
    for mod in ("__init__.py", "gptneox.py", "bert.py"):
        assert PORT / "models" / mod in SOURCES, mod
    # Mllama: the model, its decoder, the channel-parallel convs, LoRA's
    # grouped-stack registry
    assert PORT / "models" / "mllama.py" in SOURCES
    assert PORT / "inference" / "mllama_decode.py" in SOURCES
    assert PORT / "lora" / "stacks.py" in SOURCES
    # the parallel layer: the mesh, the regions, the layers, the loss
    for mod in ("state.py", "multihost.py", "mappings.py", "random.py", "pad.py",
                "layers.py", "layout.py", "loss.py", "grads.py", "conv.py"):
        assert PORT / "parallel" / mod in SOURCES, mod


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(imported_top_levels(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_tells_the_packages_apart(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import neuronx_distributed_llama3_2_tpu_torch.models\n"
        "from neuronx_distributed_llama3_2_tpu.serving import engine\n"
        "def f():\n    import jax.numpy as jnp\n"
    )
    found = set(imported_top_levels(src))
    assert found & FORBIDDEN == {"neuronx_distributed_llama3_2_tpu", "jax"}
    assert "neuronx_distributed_llama3_2_tpu_torch" in found
