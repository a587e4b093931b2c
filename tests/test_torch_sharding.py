"""The port's logical-axis sharding rule engine
(``repro_torch.distributed.sharding``) and the LM's ``param_axes()``,
held against the JAX package on mesh stand-ins with no process group:
every ``ARCH_IDS`` configuration's parameter axes, shapes and specs at the
published widths on the ``(16, 16)``, ``(2, 16, 16)`` and ``(4, 2)`` meshes
under all three rule sets, ``batch_spec``, a hypothesis property of
``tests/test_sharding_properties.py:51``'s invariants (the port's spec
equal to the reference's on each drawn case), and the placements a
``NamedSharding`` gives."""

import functools

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get as ref_get
from repro.distributed import sharding as RS
from repro.models.lm import LM as RefLM
from repro_torch.bridge import _layout
from repro_torch.configs import ARCH_IDS, get
from repro_torch.distributed import sharding as S
from repro_torch.models.lm import LM


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "4x2": {"data": 4, "model": 2},
}
RULES = {"tp": (RS.DEFAULT_RULES, S.DEFAULT_RULES), "fsdp": (RS.FSDP_RULES, S.FSDP_RULES),
         "sp_zero3": (RS.SP_RULES, S.SP_RULES)}


def test_rule_sets_are_the_references():
    assert S.RULE_SETS.keys() == RS.RULE_SETS.keys()
    for name in S.RULE_SETS:
        assert S.RULE_SETS[name] == RS.RULE_SETS[name], name


def _key_path(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                    for k in path)


def _is_axes(a) -> bool:
    return isinstance(a, tuple) and all(isinstance(x, (str, type(None))) for x in a)


@functools.lru_cache(maxsize=None)
def reference_model(arch: str):
    """The reference LM's parameter shapes and axes at the published widths."""
    model = RefLM(ref_get(arch))
    return jax.eval_shape(model.init, jax.random.PRNGKey(0)), model.param_axes()


@functools.lru_cache(maxsize=None)
def reference_tree(arch: str) -> dict[str, tuple]:
    """``{port path: (shape, axes)}`` of the reference LM's parameters at
    the published widths, its stacked units split per layer (the stacked
    axis dropped from shapes and axes), as ``bridge.lm_params_from_jax``
    splits them."""
    cfg = ref_get(arch)
    shapes, axes = reference_model(arch)
    flat_shapes = {_key_path(p): s.shape for p, s in
                   jax.tree_util.tree_flatten_with_path(shapes)[0]}
    flat_axes = {_key_path(p): a for p, a in
                 jax.tree_util.tree_flatten_with_path(axes, is_leaf=_is_axes)[0]}
    assert flat_shapes.keys() == flat_axes.keys()
    n_head, period, n_units, _ = _layout(cfg)
    out = {}
    for path, shape in flat_shapes.items():
        ax = flat_axes[path]
        top, *rest = path.split("/")
        if top == "head":
            out[f"layers/{rest[0]}/" + "/".join(rest[1:])] = (shape, ax)
        elif top == "tail":
            out[f"layers/{n_head + n_units * period + int(rest[0])}/" + "/".join(rest[1:])] = \
                (shape, ax)
        elif top == "units":
            assert ax[0] is None and shape[0] == n_units, (path, ax, shape)
            for u in range(n_units):
                out[f"layers/{n_head + u * period + int(rest[0])}/" + "/".join(rest[1:])] = \
                    (shape[1:], ax[1:])
        else:
            out[path] = (shape, ax)
    return out


@functools.lru_cache(maxsize=None)
def port_tree(arch: str) -> dict[str, tuple]:
    model = LM(get(arch), "meta")
    axes = model.param_axes()
    return {name.replace(".", "/"): (tuple(p.shape), axes[name.replace(".", "/")])
            for name, p in model.named_parameters()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_and_shapes_are_the_references(arch):
    ref, port = reference_tree(arch), port_tree(arch)
    assert port.keys() == ref.keys()
    for path in ref:
        assert port[path] == ref[path], path


@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_parameter_spec_is_the_references(arch, mesh, rules):
    fake = FakeMesh(MESHES[mesh])
    ref_rules, port_rules = RULES[rules]
    cfg = ref_get(arch)
    shapes, axes = reference_model(arch)
    ref_specs = jax.tree.map(lambda s, a: tuple(RS.spec_for(s.shape, a, fake, ref_rules)),
                             shapes, axes, is_leaf=_is_axes)
    flat_ref = {_key_path(p): s for p, s in jax.tree_util.tree_flatten_with_path(
        ref_specs, is_leaf=lambda x: isinstance(x, tuple))[0]}
    n_head, period, n_units, _ = _layout(cfg)
    want = {}
    for path, spec in flat_ref.items():
        top, *rest = path.split("/")
        if top == "units":
            assert not spec or spec[0] is None
            for u in range(n_units):
                want[f"layers/{n_head + u * period + int(rest[0])}/" + "/".join(rest[1:])] = \
                    spec[1:]
        elif top == "head":
            want[f"layers/{rest[0]}/" + "/".join(rest[1:])] = spec
        elif top == "tail":
            want[f"layers/{n_head + n_units * period + int(rest[0])}/" + "/".join(rest[1:])] = \
                spec
        else:
            want[path] = spec
    got = {path: tuple(S.spec_for(shape, axes, fake, port_rules))
           for path, (shape, axes) in port_tree(arch).items()}
    assert got == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("batch", [1, 2, 4, 8, 16, 32, 64, 256, 512, 24])
def test_batch_spec_is_the_references(mesh, batch):
    fake = FakeMesh(MESHES[mesh])
    assert tuple(S.batch_spec(fake, batch)) == tuple(RS.batch_spec(fake, batch))
    assert S.data_axis_names(fake) == RS.data_axis_names(fake)


def test_the_reference_tests_fallbacks():
    """``tests/test_distributed.py:33-63``'s cases on the port."""
    mesh = FakeMesh({"data": 16, "model": 16})
    assert S.spec_for((8192, 8, 128), ("embed", "kv_heads", "head_dim"), mesh) == \
        (None, None, "model")
    assert S.spec_for((504, 1280), ("vocab", "embed"), mesh) == ()
    assert S.spec_for((50304, 2560), ("vocab", "embed"), mesh) == ("model",)
    assert S.spec_for((50304, 2560), ("vocab", "embed"), mesh, S.FSDP_RULES) == \
        ("model", "data")
    assert S.spec_for((4096, 32, 128), ("embed", "heads", "head_dim"), mesh) == (None, "model")
    pod = FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert S.spec_for((256, 4096), ("batch", "seq"), pod) == (("pod", "data"),)
    assert S.spec_for((1, 4096), ("batch", "seq"), pod) == ()
    with pytest.raises(ValueError, match="rank"):
        S.spec_for((4, 4), ("embed",), mesh)


LOGICAL = [None, "batch", "seq", "vocab", "embed", "heads", "kv_heads",
           "head_dim", "mlp", "experts", "expert_ff", "rnn", "rnn_in", "frontend"]


@st.composite
def tensor_case(draw):
    rank = draw(st.integers(1, 4))
    dims = [draw(st.sampled_from([1, 2, 3, 8, 16, 40, 64, 128, 504, 512, 7168]))
            for _ in range(rank)]
    axes = [draw(st.sampled_from(LOGICAL)) for _ in range(rank)]
    mesh = draw(st.sampled_from(list(MESHES)))
    rules = draw(st.sampled_from(list(RULES)))
    return tuple(dims), tuple(axes), mesh, rules


@settings(max_examples=200, deadline=None)
@given(case=tensor_case())
def test_spec_invariants_and_the_references_spec(case):
    dims, axes, mesh, rules = case
    fake = FakeMesh(MESHES[mesh])
    spec = S.spec_for(dims, axes, fake, RULES[rules][1])
    assert tuple(spec) == tuple(RS.spec_for(dims, axes, fake, RULES[rules][0]))
    assert len(spec) <= len(dims)
    used = []
    for i, entry in enumerate(spec):
        names = list(S.entry_axes(entry))
        for n in names:
            assert n in fake.shape  # 1. every assigned axis exists in the mesh
            assert n not in used  # 2. no mesh axis serves two dims
            used.append(n)
        if names:  # 3. the product of the assigned axes' sizes divides the dim
            assert dims[i] % int(np.prod([fake.shape[n] for n in names])) == 0


class FakeDeviceMesh:
    """A stand-in with a ``DeviceMesh``'s names, shape and coordinate."""

    def __init__(self, names, shape, coordinate):
        self.mesh_dim_names, self.shape, self._coord = names, shape, coordinate

    def get_coordinate(self):
        return self._coord


def test_named_sharding_placements_and_local_blocks():
    from torch.distributed.tensor import Replicate, Shard

    mesh = FakeDeviceMesh(("pod", "data", "model"), (2, 4, 2), [1, 2, 0])
    sh = S.NamedSharding(mesh, S.P(("pod", "data"), None, "model"))
    assert sh.placements == (Shard(0), Shard(0), Shard(2))
    # rank (1, 2, 0) holds block 1·4 + 2 = 6 of 8 rows, block 0 of 2 columns
    assert sh.local_slices((16, 3, 8)) == (slice(12, 14), slice(0, 3), slice(0, 4))
    assert S.NamedSharding(mesh, S.P()).placements == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        S.NamedSharding(mesh, S.P(("data", "pod"))).placements
    with pytest.raises(ValueError, match="divide"):
        sh.local_slices((12, 3, 8))
    fake = FakeMesh({"data": 4, "model": 2})
    tree = {"w": np.zeros((8, 6)), "b": [np.zeros(4)]}
    got = S.tree_shardings(tree, {"w": ("embed", "mlp"), "b": [("mlp",)]}, fake)
    assert got["w"].spec == (None, "model") and got["b"][0].spec == ("model",)
