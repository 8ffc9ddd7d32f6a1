"""The port's public API against the JAX package's, module by module.

Both packages are read as source with `ast`; neither is imported, so the
check costs well under a second. Each module of `topo_renderer_tpu/` has
its counterpart at the same path in `topo_renderer_tpu_torch/`, except the
two Pallas modules (`COUNTERPART`). In each pair, every public name of the
JAX module must exist in the port's:

- top-level functions and classes, and module constants (assigned names);
- a class's methods and properties (dunders included), and its fields
  (annotated or assigned names in the class body: dataclass fields, enum
  members);
- every parameter name of a JAX function or method, in the port's
  function of the same name (the port may add others, such as
  ``device=``; ``*args``/``**kw`` name no parameter a caller can pass);
- every name in a JAX module's ``__all__``, bound in the port's module.

The only exceptions are `DIVERGENCES`, each with its reason and the row
of `ROADMAP.md` §3 ("Deliberate divergences") that lists it. An entry
whose name the port now has fails `test_no_divergence_is_stale`.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_DIR = ROOT / "topo_renderer_tpu"
PORT_DIR = ROOT / "topo_renderer_tpu_torch"

# JAX module -> its port, where the paths differ.
COUNTERPART = {
    "ops/pallas_crossing.py": "ops/crossing.py",
    "ops/pallas_dma.py": "ops/window_slice.py",
}

PALLAS_OR_XLA = "selects between the Pallas kernel and XLA; the port has one route per device"
RELAYOUT = "selects a TPU relayout, which the port does not reproduce"
FUSION_HINT = "places an XLA fusion barrier; the port's eager launches have no fusion to cut"
JIT_CACHE = "keeps the jit cache whole; the port has no jit cache"
PALLAS_HELPER = "names the Pallas module's own helpers; the port's kernel has its own interface"

# Gap -> (reason, the ROADMAP.md §3 row that lists it). A gap is written
# "<JAX module>: <name>", where a name is `f`, `Class.member`, `f(param)`
# or `__all__: name`.
DIVERGENCES = {
    "ops/panorama.py: extract_clipmap_windows(force_xla)": (PALLAS_OR_XLA, "extract_clipmap_windows(force_xla=)"),
    "ops/pallas_crossing.py: pallas_available": (PALLAS_OR_XLA, "pallas_available, dma_available"),
    "ops/pallas_dma.py: dma_available": (PALLAS_OR_XLA, "pallas_available, dma_available"),
    "ops/panorama.py: panorama_crossing_prepass(col_shuffle)": (RELAYOUT, "panorama_crossing_prepass(col_shuffle=)"),
    "ops/raycast.py: march_guided_panorama(fusion_barrier)": (FUSION_HINT, "fusion_barrier="),
    "ops/raycast.py: render_perspective(fusion_barrier)": (FUSION_HINT, "fusion_barrier="),
    "models/scene.py: MosaicHostData.__eq__": (JIT_CACHE, "MosaicHostData.__eq__, __hash__"),
    "models/scene.py: MosaicHostData.__hash__": (JIT_CACHE, "MosaicHostData.__eq__, __hash__"),
    "ops/pallas_crossing.py: LANES": (PALLAS_HELPER, "LANES"),
    "ops/pallas_crossing.py: crossing_search_pallas": (PALLAS_HELPER, "crossing_search_pallas"),
    "ops/pallas_dma.py: window_slice(sy)": (PALLAS_HELPER, "window_slice(table, sy, sx)"),
    "ops/pallas_dma.py: window_slice(sx)": (PALLAS_HELPER, "window_slice(table, sy, sx)"),
}


def _public(name: str) -> bool:
    return not name.startswith("_") or (name.startswith("__") and name.endswith("__"))


def _params(fn) -> list[str]:
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]


def _names(target) -> list[str]:
    """The names an assignment target binds (``f.attr = ...`` binds none)."""
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for e in target.elts for n in _names(e)]
    if isinstance(target, ast.Starred):
        return _names(target.value)
    return []


def _assigned(node) -> list[str]:
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    return [n for t in targets for n in _names(t)]


def _statements(body):
    """A body's statements, those under ``if``/``try`` at its level included."""
    for node in body:
        if isinstance(node, (ast.If, ast.Try)):
            blocks = [node.body, node.orelse] + [h.body for h in getattr(node, "handlers", [])]
            blocks.append(getattr(node, "finalbody", []))
            for block in blocks:
                yield from _statements(block)
        else:
            yield node


def api(path: Path):
    """``(public, bound, all_names)``: each public name of the module
    (``f``, ``Class``, ``Class.member``, ``CONST``) mapped to its parameter
    names (None for a class, field or constant), every name the module
    binds, and its ``__all__`` (or None)."""
    public, bound, all_names = {}, set(), None
    for node in _statements(ast.parse(path.read_text()).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            bound.add(node.name)
            if _public(node.name):
                public[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            bound.add(node.name)
            if not _public(node.name):
                continue
            public[node.name] = None
            for sub in _statements(node.body):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(sub.name):
                    public[f"{node.name}.{sub.name}"] = _params(sub)
                elif isinstance(sub, (ast.Assign, ast.AnnAssign)):
                    public.update({f"{node.name}.{t}": None for t in _assigned(sub) if _public(t)})
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in _assigned(node):
                bound.add(t)
                if t == "__all__":
                    all_names = [ast.literal_eval(e) for e in node.value.elts]
                elif _public(t):
                    public[t] = None
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            bound.update((a.asname or a.name).split(".")[0] for a in node.names)
    return public, bound, all_names


JAX_MODULES = sorted(p.relative_to(JAX_DIR).as_posix() for p in JAX_DIR.rglob("*.py"))


def gaps(module: str) -> list[str]:
    """The JAX module's public names (and parameters) that its port lacks."""
    port = PORT_DIR / COUNTERPART.get(module, module)
    if not port.is_file():
        return [f"{module}: the module itself (no {port.relative_to(ROOT)})"]
    jax_api, _, jax_all = api(JAX_DIR / module)
    port_api, port_bound, _ = api(port)
    out = []
    for name, params in jax_api.items():
        if name not in port_api:
            out.append(f"{module}: {name}")
        elif params is not None and port_api[name] is not None:
            out += [f"{module}: {name}({p})" for p in params if p not in port_api[name]]
    out += [f"{module}: __all__: {n}" for n in jax_all or () if n not in port_bound]
    return out


def test_the_jax_package_has_modules():
    assert "__init__.py" in JAX_MODULES and "models/scene.py" in JAX_MODULES and len(JAX_MODULES) > 50


@pytest.mark.parametrize("module", JAX_MODULES)
def test_port_has_the_public_api(module):
    missing = [g for g in gaps(module) if g not in DIVERGENCES]
    assert not missing, "the port lacks:\n  " + "\n  ".join(missing)


def test_no_divergence_is_stale():
    every_gap = {g for m in JAX_MODULES for g in gaps(m)}
    stale = sorted(set(DIVERGENCES) - every_gap)
    assert not stale, f"DIVERGENCES entries the port now has (or that name nothing): {stale}"
    for gap, (reason, row) in DIVERGENCES.items():
        assert reason and row, gap
