"""The op-parity audit restated for the port (paddle_tpu_torch.ops.parity
against paddle_tpu.ops.parity): every forward op of the reference's five
PHI YAML files maps, in the port, to an op of its registry, an API path
that resolves in the port, or a documented exclusion, except the ones
whose reference mapping points into a module the port has not ported
yet. Those are listed here (STILL_UNMAPPED), and the list can only
shrink: a name the port maps is taken off it."""
import importlib

from paddle_tpu.ops import parity as jparity
from paddle_tpu_torch.ops import parity as tparity
from test_torch_nn_clip import PORTED_MODULES

# the YAML ops whose reference counterpart is in a module still to port:
# none (the collectives map since ROADMAP item 26a, the model-parallel
# layers' c_embedding and c_identity since item 26b)
STILL_UNMAPPED = set()


def _reference_module(name, table):
    """The reference module a YAML op maps into (its op's module, or its
    alias path's longest importable prefix)."""
    from paddle_tpu.ops.registry import OPS
    kind, detail, _ = table[name]
    if kind == "registry":
        return OPS[name].fn.__module__
    parts = detail.split(".")
    for cut in range(len(parts) - 1, 0, -1):
        try:
            importlib.import_module(".".join(parts[:cut]))
            return ".".join(parts[:cut])
        except ImportError:
            continue
    return detail


def test_snapshot_is_the_reference_snapshot():
    assert tparity.YAML_OPS == jparity.YAML_OPS


def test_every_yaml_op_is_mapped_or_still_to_port():
    table, unmapped = tparity.classify()
    names = {n for v in tparity.YAML_OPS.values() for n in v}
    assert len(table) + len(unmapped) == len(names)
    assert set(unmapped) <= STILL_UNMAPPED, sorted(
        set(unmapped) - STILL_UNMAPPED)
    done = sorted(STILL_UNMAPPED - set(unmapped))
    assert not done, f"the port now maps {done}: take them off the list"
    # none of them points into a module the port calls ported
    ref_table, ref_unmapped = jparity.classify()
    assert not ref_unmapped
    ported = {m for m, (_, todo) in PORTED_MODULES.items() if not todo}
    for name in unmapped:
        mod = _reference_module(name, ref_table)
        assert mod not in ported, (name, mod)


def test_alias_paths_resolve_in_the_port():
    table, _ = tparity.classify()
    for name, (kind, detail, _) in table.items():
        if kind == "alias":
            assert detail.startswith("paddle_tpu_torch."), name
            assert tparity.resolve_api(detail), name


def test_no_overlapping_or_stale_entries():
    from paddle_tpu_torch.ops.registry import OPS
    tparity.classify()
    assert not sorted(n for n in tparity.ALIASES if n in OPS)
    assert not sorted(n for n in tparity.EXCLUDED if n in OPS)
    assert not sorted(set(tparity.ALIASES) & set(tparity.EXCLUDED))
    # the reference's names (less those the port registers as ops:
    # flash_attn_unpadded), only the paths and reasons its own
    assert set(tparity.ALIASES) == set(jparity.ALIASES) - set(OPS)
    assert set(tparity.EXCLUDED) == set(jparity.EXCLUDED)
    for name, path in tparity.ALIASES.items():
        assert path == jparity.ALIASES[name].replace(
            "paddle_tpu.", "paddle_tpu_torch.", 1)
    assert not any("XLA" in r or "TPU" in r or "jax" in r
                   for r in set(tparity.EXCLUDED.values()))


def test_registry_mapped_names_of_the_reference_stay_registry_ops():
    """A YAML op the reference computes by a registered op of a module
    the port has ported is a registered op of the port too."""
    from paddle_tpu.ops.registry import OPS as JOPS
    from paddle_tpu_torch.ops.registry import OPS
    ref_table, _ = jparity.classify()
    ported = {m for m, (_, todo) in PORTED_MODULES.items() if not todo}
    missing = sorted(n for n, (kind, _, _) in ref_table.items()
                     if kind == "registry" and JOPS[n].fn.__module__
                     in ported and n not in OPS)
    assert not missing
