"""Every public function and class of every ``wcmc_tpu`` module has a
counterpart of the same name in the same module of ``wcmc_tpu_torch``,
except the JAX-specific ones listed here (``ROADMAP.md``'s table), each with
the port's replacement.  The modules are read with ``ast``, not imported."""

import ast
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]

# (module, name) -> what the port has in its place
JAX_SPECIFIC = {
    ("cli.py", "configure_backend"): "--device and utils.resolve_device",
    ("models/kpcn.py", "pad_like"): "none needed: nn.Module shapes are concrete",
    ("ops/pallas_kernels.py", "gather_tpu"): "ops/kernel_apply.py gather, gather_softmax",
    ("ops/pallas_kernels.py", "scatter_tpu"): "ops/kernel_apply.py scatter, scatter_softmax",
    ("ops/pallas_kernels.py", "outer_tpu"): "ops/kernel_apply.py outer",
    ("ops/pallas_kernels.py", "outer_softmax_tpu"): "ops/kernel_apply.py outer_softmax",
    ("parallel/mesh.py", "batch_spec"): "the loaders' shard=(rank, n)",
    ("train/state.py", "ModelState"): "nn.Module + train/state.py AdamWithClip",
    ("train/state.py", "init_model_state"): "nn.Module + train/state.py AdamWithClip",
}


def _public(package):
    """{module path: public top-level functions, classes and CamelCase
    aliases}."""
    out = {}
    for path in sorted((ROOT / package).rglob("*.py")):
        names = set()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                names |= {t.id for t in node.targets if isinstance(t, ast.Name)
                          and t.id[:1].isupper() and not t.id.isupper()}
        out[path.relative_to(ROOT / package).as_posix()] = {
            n for n in names if not n.startswith("_")}
    return out


def test_every_public_name_has_a_counterpart():
    ref, port = _public("wcmc_tpu"), _public("wcmc_tpu_torch")
    missing = {(module, name) for module, names in ref.items() for name in names
               if name not in port.get(module, set())}
    assert missing == set(JAX_SPECIFIC)
