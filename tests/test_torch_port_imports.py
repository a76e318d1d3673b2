"""PyTorch port, import boundary: no module of ``yat_tpu_torch/`` and not
``chip_smoke.py`` (nor ``tools/synth_checkpoint.py``, which it imports, nor
the multi-process tests' worker and their file, which the card's machine
collects) imports JAX, flax, optax, the JAX package or ``safetensors`` (the card's
machine has none; the port reads the format itself).  A static scan of
the source (the test process itself has JAX loaded, so ``sys.modules``
says nothing).  The native decoder's library is built inside the port's
own build directory."""

import ast
from pathlib import Path

import pytest
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "yat_tpu", "safetensors")
SOURCES = sorted((ROOT / "yat_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "synth_checkpoint.py",
    ROOT / "tests" / "torch_mp_worker.py",
    ROOT / "tests" / "test_torch_port_multiprocess.py"]


def _forbidden(module: str) -> bool:
    # exact top-level match: yat_tpu_torch is allowed, yat_tpu is not
    return module.split(".")[0] in FORBIDDEN


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.lineno, node.args[0].value


def test_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert {"yat_tpu_torch/models/sana.py", "yat_tpu_torch/serve.py",
            "yat_tpu_torch/adapters/builder.py", "yat_tpu_torch/adapters/io.py",
            "yat_tpu_torch/train/engine.py", "yat_tpu_torch/train/step.py",
            "yat_tpu_torch/train/checkpoint.py",
            "yat_tpu_torch/data/tar.py", "yat_tpu_torch/data/sampler.py",
            "yat_tpu_torch/utils/logging.py",
            "yat_tpu_torch/parallel/multihost.py",
            "yat_tpu_torch/parallel/mesh.py",
            "yat_tpu_torch/parallel/tensor.py",
            "yat_tpu_torch/ops/context_parallel.py", "tests/torch_mp_worker.py",
            "tests/test_torch_port_multiprocess.py", "yat_tpu_torch/ops/quant.py",
            "yat_tpu_torch/ops/opt8bit.py", "yat_tpu_torch/data/bins.py",
            "yat_tpu_torch/data/native.py", "yat_tpu_torch/data/r2.py",
            "yat_tpu_torch/data/generate_shards.py",
            "yat_tpu_torch/train/encode.py", "yat_tpu_torch/train/extract.py",
            "yat_tpu_torch/models/mmdit.py", "yat_tpu_torch/frontends/sd35.py",
            "yat_tpu_torch/models/flux.py", "yat_tpu_torch/frontends/flux.py",
            "chip_smoke.py"} <= names


def test_native_decoder_builds_inside_the_port():
    """The port builds ``native/decode.cpp`` into its own ``_build/``
    (gitignored), never into or from the JAX package's
    ``native/libyatdecode.so``; importing the module builds nothing."""
    from yat_tpu_torch.data import native

    assert native.SOURCE == ROOT / "native" / "decode.cpp"
    assert native.BUILD_DIR == ROOT / "yat_tpu_torch" / "_build"
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith("libyatdecode-") and path.suffix == ".so"
    assert "libyatdecode.so" not in (
        ROOT / "yat_tpu_torch" / "data" / "native.py").read_text()
    assert "yat_tpu_torch/_build/" in (ROOT / ".gitignore").read_text()


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = [(line, mod) for line, mod in imported_modules(path)
           if _forbidden(mod)]
    assert not bad, f"{path.name} imports {bad}"


def test_matcher_is_exact():
    assert _forbidden("yat_tpu.ops.norm") and _forbidden("jax.numpy")
    assert _forbidden("yat_tpu") and _forbidden("flax.linen")
    assert not _forbidden("yat_tpu_torch.ops.norm")
    assert not _forbidden("jaxtyping_like") and not _forbidden("torch")
    assert _forbidden("safetensors.numpy")
