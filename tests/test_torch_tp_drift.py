"""Where mamba2's f32 logits drift from the unsharded model's on 4 ranks.

On the card, mamba2-370m placed on (data 1, model 4) gave f32 logits
4.6e-5 of the row's largest away from the unsharded model's, against
hymba's 3.3e-6 (``chip_smoke.py``'s tp_families phase A). Its SSD heads
divide ``model`` (case 1 of ``models/ssm.py``), and a layer's work on a
rank differs from the unsharded layer's in two sums over ``model`` only:
the gated norm's sum of squares (``rms_norm(..., split=)``) and the
row-parallel ``out_proj``'s partial products (``sum_over``), each added in
rank order where the unsharded layer reduces over the whole ``d_inner``.

A REDUCED mamba2 cut to the published 48 layers, f32, in a gloo world of
4 CPU ranks, against the unsharded model of the same seed on the same
tokens, four ways: as placed; with the norm's statistic taken over the
gathered whole ``d_inner`` as the unsharded layer takes it; with
``out_proj`` applied to the gathered whole input and weight; with both.
With both the placed model gives the unsharded logits bit for bit, at
every layer: those two sums are the whole drift, and it is summation
order, not a fault. The residual stream's error grows with depth, layer
by layer; most of it comes from ``out_proj``'s sum (its removal cuts the
logits' drift 2.5x on these inputs, the norm's not at all). The drift
stays within ``chip_smoke.TP_LOGITS_RTOL`` (1e-4 of the row's largest),
the bound the smoke holds every placed model's f32 logits to.
"""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = 48
TP_LOGITS_RTOL = 1e-4     # chip_smoke.py's bound on placed f32 logits
VARIANTS = {"as placed": (False, False), "norm exact": (True, False),
            "out_proj exact": (False, True), "both exact": (True, True)}

_RANK = r"""
import contextlib, dataclasses, json, sys
import torch
import torch.nn.functional as F
from repro_torch.configs import get_config
from repro_torch.core.distributed import gather_axis, sum_over
from repro_torch.distributed import compat
from repro_torch.distributed.context import mesh_context
from repro_torch.launch import mesh as pm
from repro_torch.models import ssm
from repro_torch.models.layers import rms_norm
from repro_torch.models.model import forward, gather_vocab, init_params
torch.set_num_threads(1)
rank, out, layers, variants = int(sys.argv[1]), sys.argv[2], \
    int(sys.argv[3]), eval(sys.argv[4])
compat.init_ranks("gloo", f"file://{out}/rendezvous", rank, 4)
cfg = dataclasses.replace(get_config("mamba2-370m", reduced=True),
                          dtype="float32", n_layers=layers)
g = torch.Generator().manual_seed(3)
batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 64), generator=g)}
placed_gate_out = ssm._gate_out
M = ("model",)

def gate_out(exact_norm, exact_out):
    # case 1's _gate_out with either sum over model taken as the
    # unsharded layer takes it, over the gathered whole d_inner
    def fn(y, z, params, cfg, dtype, sp=None):
        y = (y * F.silu(z.float())).to(dtype)
        if exact_norm:
            n = y.shape[-1]
            y = rms_norm(gather_axis(sp.mesh, "model", y, -1),
                         gather_axis(sp.mesh, "model", params["ssm_norm"], -1),
                         cfg.norm_eps).narrow(-1, sp.index * n, n)
        else:
            y = rms_norm(y, params["ssm_norm"], cfg.norm_eps,
                         split=(sp.mesh, M))
        if exact_out:
            return gather_axis(sp.mesh, "model", y, -1) @ gather_axis(
                sp.mesh, "model", params["out_proj"], 0)
        return sum_over(sp.mesh, M, y @ params["out_proj"])
    return fn

def run(model, ctx):
    acts = []
    # a block returns its output, or (output, its MoE aux loss)
    hooks = [b.register_forward_hook(lambda m, i, o: acts.append(
        (o if torch.is_tensor(o) else o[0]).detach().clone()))
        for b in model.blocks]
    with ctx, torch.no_grad():
        logits = gather_vocab(model, forward(model, batch, cfg))
    for h in hooks:
        h.remove()
    return logits[..., :cfg.vocab_size], acts

want, want_acts = run(init_params(cfg, 7, "cpu"), contextlib.nullcontext())
mesh = pm.make_mesh((1, 4), ("data", "model"))
with mesh_context(mesh):
    placed = init_params(cfg, 7, "cpu")
res = {}
for name, (exact_norm, exact_out) in variants.items():
    ssm._gate_out = gate_out(exact_norm, exact_out) \
        if exact_norm or exact_out else placed_gate_out
    got, acts = run(placed, mesh_context(mesh, batch=2))
    res[name] = {
        "logits_rel": float(((got - want).abs().amax(-1)
                             / want.abs().amax(-1)).max()),
        "bit_for_bit": bool(torch.equal(got, want)) and all(
            torch.equal(a, b) for a, b in zip(acts, want_acts)),
        "layers_rel": [float((a - b).abs().max() / b.abs().max())
                       for a, b in zip(acts, want_acts)]}
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump(res, f)
compat.shutdown()
"""


@pytest.fixture(scope="module")
def drift(tmp_path_factory):
    """{rank: {variant: {"logits_rel", "bit_for_bit", "layers_rel"}}}."""
    out = tmp_path_factory.mktemp("drift")
    (out / "rank.py").write_text(_RANK)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(out / "rank.py"), str(r), str(out),
         str(LAYERS), repr(VARIANTS)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    for p in procs:
        so, se = p.communicate(timeout=300)
        assert p.returncode == 0, so + se
    return {r: json.loads((out / f"rank{r}.json").read_text())
            for r in range(4)}


def test_the_two_sums_over_model_are_the_whole_drift(drift):
    """With the norm's statistic and ``out_proj`` both taken over the
    whole ``d_inner``, the placed model's every layer and logits are the
    unsharded model's bit for bit, on every rank."""
    for r in range(4):
        assert drift[r]["both exact"]["bit_for_bit"], r
        assert drift[r]["both exact"]["logits_rel"] == 0.0, r


@pytest.mark.parametrize("variant", ["as placed", "norm exact",
                                     "out_proj exact"])
def test_the_rank_order_sums_drift_within_the_placed_logits_bound(
        drift, variant):
    """With either sum in rank order the logits differ from the unsharded
    ones (summation order), within TP_LOGITS_RTOL of the row's largest
    at 48 layers, the same on every rank."""
    got = drift[0][variant]
    assert not got["bit_for_bit"]
    assert 0.0 < got["logits_rel"] <= TP_LOGITS_RTOL, got["logits_rel"]
    for r in range(1, 4):
        assert drift[r][variant]["logits_rel"] == got["logits_rel"], r


def test_the_drift_grows_with_depth_from_the_first_layer(drift):
    """As placed, the residual stream already differs after layer 0 and
    its error grows with depth: the last quarter's worst is above the
    first quarter's (an accumulation over the layers, not one layer's
    fault)."""
    layers = drift[0]["as placed"]["layers_rel"]
    assert len(layers) == LAYERS and layers[0] > 0.0
    q = LAYERS // 4
    assert max(layers[-q:]) > max(layers[:q])
    assert max(layers) <= TP_LOGITS_RTOL
