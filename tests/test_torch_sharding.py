"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's, with no process groups: every parameter spec of every
architecture at full width on the production meshes (the port's model on
the meta device against the reference's ``eval_shape`` params on an
``AbstractMesh``), the batch, cache and activation specs over a grid of
sizes, and ``local_block``'s blocks reassembling the whole tensor.

Specs are compared exactly; the reference's spec of a stacked ``[L,
...]`` leaf is the port's spec of each layer's parameter with ``None``
(the layer dim) in front.
"""
import functools
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import models as R  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.distributed.compat import abstract_mesh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
DISTS = {"default": {}, "fsdp_over_pod": {"fsdp_over_pod": True},
         "head_dim_fallback": {"shard_head_dim_fallback": True}}


def _meshes(m):
    shape, names = MESHES[m]
    return abstract_mesh(shape, names), shd.MeshShape(names, shape)


def _dists(d):
    return ref_shd.DistConfig(**DISTS[d]), shd.DistConfig(**DISTS[d])


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = ref_get_config(arch)
    return jax.eval_shape(lambda k: R.init_params(k, cfg),
                          jax.random.PRNGKey(0))


def _ref_specs(arch, mesh, dist):
    """{the reference's leaf name, dot-joined: tuple spec}."""
    specs = ref_shd.param_specs(_ref_params(arch), mesh, dist)
    flat = jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    return {".".join(ref_shd._path_names(path)): tuple(spec)
            for path, spec in flat}


@pytest.mark.parametrize("d", sorted(DISTS))
@pytest.mark.parametrize("m", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference(arch, m, d):
    ref_mesh, mesh = _meshes(m)
    ref_dist, dist = _dists(d)
    want = _ref_specs(arch, ref_mesh, ref_dist)
    got = shd.param_specs(LM(get_config(arch), "meta"), mesh, dist)
    seen = set()
    for name, spec in got.items():
        path, stacked = shd.reference_path(name)
        ref = want[".".join(path)]
        assert (None,) + spec == ref if stacked else spec == ref, name
        seen.add(".".join(path))
    assert seen == set(want)
    # the moe family's experts go over model; every dense weight of the
    # big archs is sharded somewhere, as the reference's test asks
    if get_config(arch).n_experts:
        assert got["blocks.0.moe.w_gate"][0] == "model"


def test_param_specs_shard_the_big_weights():
    """Something of every weight of more than 2 GiB in bf16 is sharded on
    the 16x16 mesh (kimi-k2's experts, command-r's embedding)."""
    _, mesh = _meshes("16x16")
    for arch in ("internvl2-76b", "command-r-plus-104b", "kimi-k2-1t-a32b"):
        model = LM(get_config(arch), "meta")
        specs = shd.param_specs(model, mesh)
        for name, p in model.named_parameters():
            if p.numel() * 2 > 2 * 2 ** 30:
                assert any(e is not None for e in specs[name]), name


@pytest.mark.parametrize("m", sorted(MESHES) + ["2x4", "1x8"])
def test_batch_and_activation_specs_match_the_reference(m):
    shape, names = {"2x4": ((2, 4), ("data", "model")),
                    "1x8": ((1, 8), ("data", "model"))}.get(m) or MESHES[m]
    ref_mesh, mesh = abstract_mesh(shape, names), shd.MeshShape(names, shape)
    for d in DISTS:
        ref_dist, dist = _dists(d)
        for b, extra in itertools.product((1, 2, 3, 16, 32, 64), (0, 1, 2)):
            assert shd.batch_spec(b, mesh, dist, extra) == tuple(
                ref_shd.batch_spec(b, ref_mesh, ref_dist, extra))
        for b, h, hd in itertools.product((1, 16, 32), (12, 20, 25, 32, 64),
                                          (64, 80, 112, 128)):
            assert shd.head_act_spec(mesh, b, h, hd, dist) == tuple(
                ref_shd.head_act_spec(ref_mesh, b, h, hd, ref_dist))
    for b, ff in itertools.product((1, 4, 16, 32), (96, 2048, 5632, 10752)):
        assert shd.token_act_spec(mesh, b) == tuple(
            ref_shd.token_act_spec(ref_mesh, b))
        assert shd.ff_act_spec(mesh, b, ff) == tuple(
            ref_shd.ff_act_spec(ref_mesh, b, ff))


@pytest.mark.parametrize("m", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_the_reference(arch, m):
    ref_mesh, mesh = _meshes(m)
    for d in DISTS:
        ref_dist, dist = _dists(d)
        for b, seq in itertools.product((1, 8, 32, 64),
                                        (None, 7, 48, 4096)):
            want = ref_shd.cache_spec(ref_get_config(arch), b, ref_mesh,
                                      ref_dist, seq)
            got = shd.cache_spec(get_config(arch), b, mesh, dist, seq)
            assert got == {k: tuple(v) for k, v in want.items()}, (b, seq)


def test_local_block_reassembles_the_tensor():
    """On a (2, 2, 2) mesh the ranks' ``local_block``s of a tensor under a
    spec are boxes of it that cover it exactly once (replicated dims
    aside: a rank sharing a block holds the same one), the index of a
    dim's block row-major over its entry's axes, the first major. That
    this is where jax places each block is held in
    ``tests/test_torch_moe_ep.py`` on 8 host devices. A dim the group
    does not divide raises."""
    shape, names = (2, 2, 2), ("pod", "data", "model")
    x = np.arange(8 * 4 * 16).reshape(8, 4, 16)
    specs = [(("pod", "data"), None, "model"), ("model", "pod", "data"),
             (None, None, ("data", "pod", "model")), (None, None, None)]
    for spec in specs:
        count = np.zeros(x.shape, int)
        blocks = {}
        for coords in itertools.product(*map(range, shape)):
            mesh = Mesh(names, shape, coords, {})
            block = shd.local_block(torch.from_numpy(x), spec, mesh).numpy()
            start = np.unravel_index(block.flat[0], x.shape)
            box = tuple(slice(i, i + n) for i, n in zip(start, block.shape))
            np.testing.assert_array_equal(block, x[box])
            if box not in blocks:
                count[box] += 1
            blocks[box] = coords
        assert (count == 1).all(), spec
        n_blocks = np.prod([shd.group_size(mesh, e) for e in spec])
        assert len(blocks) == n_blocks
    # rows over (pod, data): pod 1, data 0 -> the third of four blocks
    mesh = Mesh(names, shape, (1, 0, 1), {})
    got = shd.local_block(torch.from_numpy(x), specs[0], mesh).numpy()
    np.testing.assert_array_equal(got, x[4:6, :, 8:])
    # columns over (data, pod, model): data 0, pod 1, model 1 -> block 3
    got = shd.local_block(torch.from_numpy(x), specs[2], mesh).numpy()
    np.testing.assert_array_equal(got, x[:, :, 6:8])
    with pytest.raises(ValueError, match="does not split"):
        shd.local_block(torch.zeros(3, 4), ("data", None),
                        Mesh(names, shape, (0, 0, 0), {}))


def test_dist_config_folds_pod_into_data():
    mesh = shd.MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert shd.DistConfig().logical("data", mesh) == ("data",)
    assert shd.DistConfig(fsdp_over_pod=True).logical("data", mesh) == (
        "pod", "data")
    assert shd.DistConfig().logical("model", mesh) == ("model",)
    two = shd.MeshShape(("data", "model"), (16, 16))
    assert shd.DistConfig(fsdp_over_pod=True).logical("data", two) == (
        "data",)


def test_factored_statistics_drop_the_reduced_dim():
    """``row`` / ``col`` of a factored second moment take the parent
    parameter's rule without the dim they reduce, as the reference's."""
    mesh = shd.MeshShape(("data", "model"), (16, 16))
    ref_mesh = abstract_mesh((16, 16), ("data", "model"))
    dist, ref_dist = shd.DistConfig(), ref_shd.DistConfig()
    for path, shape in ((("blocks", "mlp", "w_gate", "row"), (4, 2048)),
                        (("blocks", "mlp", "w_gate", "col"), (4, 5632)),
                        (("blocks", "moe", "w_down", "row"), (4, 16, 2048)),
                        (("tok_embed", "col"), (4096,))):
        for stacked in (False, True):
            want = ref_shd.spec_for_leaf(path, shape, ref_mesh, ref_dist,
                                         stacked)
            assert shd.spec_for_leaf(path, shape, mesh, dist,
                                     stacked) == tuple(want)


def test_reference_path_drops_the_layer_index():
    assert shd.reference_path("blocks.3.attn.wq") == (
        ("blocks", "attn", "wq"), True)
    assert shd.reference_path("dense_blocks.0.mlp.w_up") == (
        ("dense_blocks", "mlp", "w_up"), True)
    assert shd.reference_path("encoder.11.attn_norm") == (
        ("encoder", "attn_norm"), True)
    assert shd.reference_path("tok_embed") == (("tok_embed",), False)
    names = dict(LM(get_config("dbrx-132b", reduced=True),
                    "meta").named_parameters())
    assert "blocks.1.moe.w_gate" in names
