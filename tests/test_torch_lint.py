"""The port's own copies of the reference's protocol lints
(``scripts/lint_protocol.py``).

Rule 1, table ownership: outside ``src/repro_torch/core/`` no assignment
(plain, augmented, annotated, or through a subscript or a tuple) writes
through an attribute named ``wts`` / ``rts`` / ``_wts`` / ``_rts``, so the
``(wts, rts)`` tables change only through the ``LeaseEngine`` / protocol
API (or the ``set_tables`` seam) and the invariants the model checker
proves keep their meaning.

Rule 2, kernel oracles: every public op in
``src/repro_torch/kernels/*/ops.py`` has a ``<name>_ref`` mirror in the
sibling ``ref.py`` whose parameters are a same-order prefix of the op's,
with any op-only extras defaulted, so a differential test can call both
sides with the same arguments.  It walks the sources with ``ast`` and
expects no finding.

Beside it, the two mirrors this rule asked for are held to the JAX
package's: ``ssd_scan_ref`` to ``repro.kernels.ssd_scan.ref.ssd_scan_ref``
and ``decode_attention_ref`` to ``repro.kernels.decode_attention.ref``'s,
on seeded numpy inputs at fp32's 2e-4 (``tests/test_kernels.py``)."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.kernels.decode_attention import ops as DO
from repro_torch.kernels.ssd_scan import ops as SO

try:
    import jax.numpy as jnp
    from repro.kernels.decode_attention.ref import \
        decode_attention_ref as j_decode_ref
    from repro.kernels.ssd_scan.ref import ssd_scan_ref as j_ssd_ref
except ImportError:      # the card's machine has no JAX
    jnp = None

PKG = Path(repro_torch.__file__).resolve().parent
KERNELS = PKG / "kernels"
FP32 = dict(rtol=2e-4, atol=2e-4)
TS_NAMES = {"wts", "rts", "_wts", "_rts"}


def _attr_target(node):
    """The Attribute node a store target writes through, if any."""
    if isinstance(node, ast.Attribute):
        return node
    if isinstance(node, (ast.Subscript, ast.Starred)):
        return _attr_target(node.value)
    return None


def table_mutation_findings(path: Path, tree) -> list:
    """Rule 1 on one module: a line per store through a timestamp-table
    attribute."""
    findings = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            targets = []
            for t in node.targets:
                targets += t.elts if isinstance(t, ast.Tuple) else [t]
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        else:
            continue
        for t in targets:
            attr = _attr_target(t)
            if attr is not None and attr.attr in TS_NAMES:
                findings.append(
                    f"{path}:{node.lineno}: mutates timestamp table "
                    f"attribute '.{attr.attr}' outside core/ (use the "
                    f"LeaseEngine/protocol API)")
    return findings


def test_tables_are_mutated_only_in_core():
    """Rule 1 over every module of the port outside ``core/``."""
    walked, findings = 0, []
    for path in sorted(PKG.rglob("*.py")):
        if path.relative_to(PKG).parts[0] == "core":
            continue
        walked += 1
        findings += table_mutation_findings(path.relative_to(PKG),
                                            ast.parse(path.read_text()))
    assert walked > 30
    assert findings == []


@pytest.mark.parametrize("src", ["engine._rts[idx] = 0\n",
                                 "self.wts, other = a, b\n",
                                 "eng.rts += 1\n",
                                 "d.shards[0]._wts: object = None\n"])
def test_rule_1_finds_a_planted_table_write(src):
    found = table_mutation_findings(Path("runtime/x.py"), ast.parse(src))
    assert len(found) == 1 and "timestamp table" in found[0], found


def test_rule_1_finds_the_reference_mutations_and_passes_reads():
    """The reference's planted lines (``tests/test_model_check.py``'s lint
    case): three findings; reads and other attributes none."""
    bad = ast.parse("engine._rts[idx] = 0\n"
                    "self.wts, other = a, b\n"
                    "eng.rts += 1\n")
    assert len(table_mutation_findings(Path("runtime/x.py"), bad)) == 3
    good = ast.parse("local_copy = engine.rts\n"
                     "engine.other[idx] = 0\n"
                     "wts = 3\n")
    assert table_mutation_findings(Path("runtime/x.py"), good) == []


def _params(fn):
    """Ordered (name, has_default) of a def's positional and keyword-only
    parameters."""
    a = fn.args
    pos = list(a.posonlyargs) + list(a.args)
    out = [(arg.arg, k >= len(pos) - len(a.defaults))
           for k, arg in enumerate(pos)]
    out += [(arg.arg, d is not None)
            for arg, d in zip(a.kwonlyargs, a.kw_defaults)]
    return out


def mirror_findings(kdir: Path) -> list:
    """Rule 2 on one kernel package: one line per public op of its
    ``ops.py`` without a matching ``<name>_ref`` in its ``ref.py``."""
    ops_path, ref_path = kdir / "ops.py", kdir / "ref.py"
    if not ref_path.exists():
        return [f"{ops_path}: kernel has no ref.py oracle module"]
    refs = {n.name: n for n in ast.parse(ref_path.read_text()).body
            if isinstance(n, ast.FunctionDef)}
    findings = []
    for node in ast.parse(ops_path.read_text()).body:
        if not isinstance(node, ast.FunctionDef) or node.name.startswith("_"):
            continue
        where = f"{kdir.name}/ops.py:{node.lineno}"
        mirror = refs.get(node.name + "_ref")
        if mirror is None:
            findings.append(f"{where}: public op '{node.name}' has no "
                            f"'{node.name}_ref' mirror in ref.py")
            continue
        op, ref = _params(node), _params(mirror)
        op_names, ref_names = [n for n, _ in op], [n for n, _ in ref]
        if op_names[:len(ref_names)] != ref_names:
            findings.append(f"{where}: '{node.name}' params {op_names} do "
                            f"not start with its mirror's {ref_names}")
            continue
        extras = [n for n, d in op[len(ref):] if not d]
        if extras:
            findings.append(f"{where}: '{node.name}' op-only params "
                            f"{extras} need defaults")
    return findings


def _kernel_dirs():
    return sorted(d.name for d in KERNELS.iterdir()
                  if (d / "ops.py").exists())


def test_every_kernel_package_is_walked():
    assert set(_kernel_dirs()) >= {"decode_attention", "flash_attention",
                                   "rmsnorm", "ssd_scan", "tardis_lease"}


@pytest.mark.parametrize("kdir", _kernel_dirs())
def test_public_ops_have_ref_mirrors(kdir):
    assert mirror_findings(KERNELS / kdir) == []


def test_the_rule_finds_a_missing_mirror(tmp_path):
    """The rule is not vacuous: an op without a mirror, one whose mirror's
    parameters differ, and one with an undefaulted extra are each found."""
    (tmp_path / "ops.py").write_text(
        "def a(x, y):\n    pass\n"
        "def b(x, y):\n    pass\n"
        "def c(x, y, z):\n    pass\n"
        "def _private(x):\n    pass\n")
    (tmp_path / "ref.py").write_text(
        "def b_ref(y):\n    pass\n"
        "def c_ref(x, y):\n    pass\n")
    found = mirror_findings(tmp_path)
    assert len(found) == 3
    assert "'a' has no 'a_ref'" in found[0]
    assert "do not start" in found[1] and "['z']" in found[2]


@pytest.mark.parametrize("s,chunk,seed", [(40, 16, 0), (64, 64, 1),
                                          (70, 32, 2)])
def test_ssd_scan_ref_matches_jax(s, chunk, seed):
    b, h, p, n = 2, 3, 8, 16
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    arrs = (x, dt, A, B, C, D)
    jy, jstate = j_ssd_ref(*(jnp.asarray(a) for a in arrs), chunk=chunk)
    y, state = SO.ssd_scan_ref(*(torch.from_numpy(a) for a in arrs),
                               chunk=chunk)
    assert y.dtype == torch.float32 and y.shape == (b, s, h, p)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **FP32)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **FP32)


def test_decode_attention_ref_matches_jax():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 1, 8, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    want = j_decode_ref(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), 17)
    got = DO.decode_attention_ref(torch.from_numpy(q), torch.from_numpy(kc),
                                  torch.from_numpy(vc), 17)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    assert DO.dense_decode_attention_ref is DO.decode_attention_ref
