"""The port's MoE (elasticdl_tpu_torch/parallel/moe.py and the MoE
transformer) against the reference's, on the CPU, from the same numpy
inputs and weights.

Routing is discrete: dispatch (which tokens go where, the capacity drops
included) must be equal bit for bit. Tolerances: combine (dispatch x the
float32 gate) 1e-6 absolute in float32, one bf16 spacing of the gate
(2^-8) in bfloat16; the aux loss 1e-6 relative in float32, 2^-7 in
bfloat16 (one rounding of the float32 value); `moe_ffn_local`'s output
and gradients 1e-5 absolute + 1e-4 relative (float32 products in another
summation order). Whole models follow tests/test_torch_transformer_lm.py:
float32 logits and loss 1e-4, flat gradients 1e-5 absolute + 1e-3
relative. A whole-model comparison can flip a token whose top-two router
probabilities are nearly equal: those tests record every layer's router
probabilities on both sides and hold the routing equal for every token
whose top-two margin exceeds ROUTE_MARGIN, and report how many tokens
fell under it.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.api.model_spec_helpers import spec_from_module as jspec_from_module
from elasticdl_tpu.common import codec as jcodec
from elasticdl_tpu.master.ps_optimizer import PSOptimizer as JPSOptimizer
from elasticdl_tpu.master.servicer import MasterServicer as JServicer
from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JDispatcher
from elasticdl_tpu.models import transformer_lm as jtlm
from elasticdl_tpu.models import transformer_lm_zoo as jzoo
from elasticdl_tpu.parallel import moe as jmoe
from elasticdl_tpu.testing import InProcessMaster as JInProcessMaster
from elasticdl_tpu.worker.worker import Worker as JWorker
from elasticdl_tpu_torch.api.model_spec_helpers import spec_from_module
from elasticdl_tpu_torch.common import codec as tcodec
from elasticdl_tpu_torch.convert import load_variables, params_from_jax
from elasticdl_tpu_torch.data.recordio import RecordIOReader
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.models import transformer_lm as ttlm
from elasticdl_tpu_torch.models import transformer_lm_zoo as tzoo
from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records
from elasticdl_tpu_torch.parallel import moe as tmoe
from elasticdl_tpu_torch.testing import InProcessMaster, build_job
from elasticdl_tpu_torch.worker.worker import Worker
from _torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

T, D, E, F_EXPERT = 256, 32, 4, 32
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ROUTE_TOL = {
    "float32": dict(combine=1e-6, aux=1e-6),
    "bfloat16": dict(combine=2.0 ** -8, aux=2.0 ** -7),
}
# a whole model: 4 experts of 32, 2 layers, head dim 16
MOE = dict(vocab=64, d_model=64, n_heads=4, d_ff=128, n_layers=2, n_experts=4, d_expert=32)
ROUTE_MARGIN = 1e-4


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, D)).astype(np.float32)
    router = (rng.standard_normal((D, E)) / math.sqrt(D)).astype(np.float32)
    w1 = (rng.standard_normal((E, D, F_EXPERT)) / math.sqrt(D)).astype(np.float32)
    w2 = (rng.standard_normal((E, F_EXPERT, D)) / math.sqrt(F_EXPERT)).astype(np.float32)
    return x, router, w1, w2


def _both_routes(x, router, capacity, dtype):
    jd, jc, ja = jmoe._route(jnp.asarray(x, JDT[dtype]), jnp.asarray(router, JDT[dtype]), E,
                             capacity)
    td, tc, ta = tmoe._route(torch.from_numpy(x).to(TDT[dtype]),
                             torch.from_numpy(router).to(TDT[dtype]), E, capacity)
    assert td.dtype == tc.dtype == ta.dtype == TDT[dtype]
    # [T, E, C]-contiguous, so the dispatch and combine products reshape
    # them as views (a copy would be 256 MiB a layer at the MoE config)
    assert td.is_contiguous() and tc.is_contiguous()
    as_np = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return ((as_np(jd), as_np(jc), float(ja)),
            (td.float().numpy(), tc.float().numpy(), float(ta)))


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_matches_reference(dtype, capacity_factor):
    """Dispatch bit for bit, combine and aux within ROUTE_TOL; at
    capacity factor 0.5 (C = 32 slots for 256 tokens over 4 experts)
    tokens are dropped, and the same ones on both sides."""
    x, router, _w1, _w2 = _inputs(seed=1)
    capacity = max(1, math.ceil(T * capacity_factor / E))
    (jd, jc, ja), (td, tc, ta) = _both_routes(x, router, capacity, dtype)
    assert td.shape == (T, E, capacity)
    assert td.tobytes() == jd.tobytes()
    tol = ROUTE_TOL[dtype]
    np.testing.assert_allclose(tc, jc, atol=tol["combine"], rtol=0)
    assert abs(ta - ja) <= tol["aux"] * abs(ja)
    kept = td.sum(axis=(1, 2))
    assert set(np.unique(kept)) <= {0.0, 1.0}
    assert (td.sum(axis=0) <= 1).all()  # one token a slot
    dropped = np.flatnonzero(kept == 0)
    np.testing.assert_array_equal(dropped, np.flatnonzero(jd.sum(axis=(1, 2)) == 0))
    if capacity_factor < 1:
        assert len(dropped) > 0 and (td.sum(axis=(0, 2)) <= capacity).all()
    else:
        assert len(dropped) == 0


def test_route_tie_takes_the_first_expert():
    """Router columns 1 and 2 equal, with integer inputs so every logit is
    exact in any summation order: every token whose best experts are 1 and
    2 goes to expert 1 on both sides (argmax takes the first index)."""
    rng = np.random.default_rng(2)
    x = rng.integers(-2, 3, (T, D)).astype(np.float32)
    router = rng.integers(-2, 3, (D, E)).astype(np.float32)
    router[:, 2] = router[:, 1]
    (jd, _jc, _ja), (td, _tc, _ta) = _both_routes(x, router, T, "float32")
    assert td.tobytes() == jd.tobytes()
    logits = x @ router
    best = logits == logits.max(axis=1, keepdims=True)
    assert best[:, 1].sum() > 0 and (best[:, 1] == best[:, 2]).all()
    expert = td.sum(axis=2).argmax(axis=1)
    np.testing.assert_array_equal(expert, best.argmax(axis=1))  # the first maximal index
    assert not td[:, 2].any()


def _ffn_loss_grads_jax(x, router, w1, w2, g_out, capacity_factor):
    def f(x, router, w1, w2):
        out, aux = jmoe.moe_ffn_local(x, router, w1, w2, capacity_factor=capacity_factor)
        return jnp.sum(out * g_out) + 0.5 * aux, (out, aux)

    grads, (out, aux) = jax.grad(f, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (x, router, w1, w2)))
    return np.asarray(out), float(aux), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
def test_moe_ffn_local_output_aux_grads_match_reference(capacity_factor):
    """Output, aux and the gradients of sum(out * g) + aux / 2 with respect
    to x, the router and both expert weights, float32, against `jax.grad`
    of the reference; with drops at capacity factor 0.5."""
    x, router, w1, w2 = _inputs(seed=3)
    g_out = np.random.default_rng(4).standard_normal((T, D)).astype(np.float32)
    jout, jaux, jgrads = _ffn_loss_grads_jax(x, router, w1, w2, g_out, capacity_factor)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, router, w1, w2)]
    out, aux = tmoe.moe_ffn_local(*leaves, capacity_factor=capacity_factor)
    loss = torch.sum(out * torch.from_numpy(g_out)) + 0.5 * aux
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(out.detach().numpy(), jout, atol=1e-5, rtol=1e-4)
    assert abs(float(aux.detach()) - jaux) <= 1e-6 * abs(jaux)
    for name, got, want in zip(("x", "router", "ew1", "ew2"), grads, jgrads):
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4, err_msg=name)
    if capacity_factor < 1:  # dropped tokens pass nothing through the FFN
        assert (np.abs(jout).sum(axis=1) == 0).sum() > 0


def _cfgs(dtype="float32", **kw):
    return (
        jtlm.TransformerConfig(**MOE, n_micro=1, dtype=JDT[dtype], **kw),
        ttlm.TransformerConfig(**MOE, dtype=TDT[dtype], **kw),
    )


def test_moe_init_params_bit_equal_and_flat_order():
    """One seed gives the reference's MoE tree bit for bit (the expert
    leaves drawn after ln2, before embed); the sorted-key flat order is
    the reference's, with router, ew1 and ew2 and without w1, w2; the
    converted tree ravels to the same flat vector."""
    jcfg, tcfg = _cfgs()
    want = jtlm.init_params(np.random.default_rng(7), jcfg)
    got = ttlm.init_params(np.random.default_rng(7), tcfg)
    assert list(got["layers"]) == list(want["layers"])
    paths = tcodec.tree_paths(got)
    assert paths == tcodec.tree_paths(want)
    assert tcodec.tree_flatten(got)[1] == tcodec.tree_flatten(want)[1]
    names = [p[-1] for p in paths]
    assert {"router", "ew1", "ew2"} <= set(names) and not {"w1", "w2"} & set(names)
    for g, w in zip(tcodec.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()
    shapes = ttlm.param_shapes(tcfg)
    for path, leaf in zip(paths, tcodec.tree_leaves(got)):
        node = shapes
        for key in path:
            node = node[key]
        assert tuple(node) == leaf.shape
    flat = tcodec.ravel_np(params_from_jax(want))
    assert flat.tobytes() == jcodec.ravel_np(want).tobytes()
    # the zoo model registers every leaf, the expert leaves included
    model = tzoo.custom_model(**MOE)
    assert {n for n, _p in model.named_parameters()} == {".".join(p) for p in paths}


def _jax_probs_recorder(records, monkeypatch):
    """Record each layer's float32 router probabilities in the reference's
    forward (its layers run under lax.scan, so through a debug callback)."""
    real = jmoe._route

    def route(x, router_w, num_experts, capacity):
        probs = jax.nn.softmax((x @ router_w).astype(jnp.float32), axis=-1)
        jax.debug.callback(lambda p: records.append(np.asarray(p)), probs, ordered=True)
        return real(x, router_w, num_experts, capacity)

    monkeypatch.setattr(jmoe, "_route", route)


def _torch_probs_recorder(records, monkeypatch):
    real = tmoe._route

    def route(x, router_w, num_experts, capacity):
        probs = torch.softmax((x @ router_w).to(torch.float32), dim=-1)
        records.append(probs.detach().float().numpy())
        return real(x, router_w, num_experts, capacity)

    monkeypatch.setattr(tmoe, "_route", route)


def _check_routing(jprobs, tprobs, n_layers):
    """Every layer's argmax expert equal for each token whose top-two
    margin (on either side) exceeds ROUTE_MARGIN; returns the number of
    tokens under the margin."""
    assert len(jprobs) == len(tprobs) == n_layers
    near = 0
    for layer, (jp, tp) in enumerate(zip(jprobs, tprobs)):
        top2 = lambda p: np.diff(np.sort(p, axis=-1)[:, -2:], axis=-1)[:, 0]  # noqa: E731
        margin = np.minimum(top2(jp), top2(tp))
        clear = margin > ROUTE_MARGIN
        near += int((~clear).sum())
        np.testing.assert_array_equal(tp.argmax(-1)[clear], jp.argmax(-1)[clear],
                                      err_msg=f"layer {layer} routes differently")
    return near


@pytest.mark.parametrize("remat", ["off", "dots"])
def test_zoo_logits_aux_loss_grads_match_reference(remat, monkeypatch):
    """The zoo's MoE model (4 experts, 2 layers, float32) from the
    reference's init: forward -> (logits, aux_weight * aux), the zoo's
    loss (cross-entropy + aux in float32) and its gradients, against the
    reference zoo's `apply` and `loss`, with the routing of every layer
    held equal; with remat "dots" on both sides too."""
    remat_kw = dict(remat=True, remat_policy="dots") if remat == "dots" else {}
    jmodel = jzoo.custom_model(**MOE, n_micro=1, **remat_kw)
    params = jtlm.init_params(np.random.default_rng(1), jmodel.cfg)
    tokens = np.random.default_rng(2).integers(0, MOE["vocab"], (2, 129)).astype(np.int32)
    jprobs, tprobs = [], []
    _jax_probs_recorder(jprobs, monkeypatch)
    _torch_probs_recorder(tprobs, monkeypatch)

    def jloss_fn(p):
        outputs = jmodel.apply({"params": p}, jnp.asarray(tokens[:, :-1]))
        return jzoo.loss(outputs, jnp.asarray(tokens[:, 1:])), outputs

    (jloss, (jlogits, jaux)), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    jax.effects_barrier()
    model = tzoo.custom_model(**MOE, **remat_kw)
    load_variables(model, params)
    tok = torch.from_numpy(tokens).long()
    logits, aux = model(tok[:, :-1])
    loss = tzoo.loss((logits, aux), tok[:, 1:])
    grads = torch.autograd.grad(loss, list(model.parameters()))
    # the backward of a remat layer recomputes its routing: forward only
    near = _check_routing(jprobs[:MOE["n_layers"]], tprobs[:MOE["n_layers"]], MOE["n_layers"])
    print(f"tokens within {ROUTE_MARGIN} of a routing tie: {near}")
    assert loss.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-4,
                               rtol=1e-4)
    assert abs(float(aux.detach()) - float(jaux)) <= 1e-6
    assert abs(float(loss.detach()) - float(jloss)) < 1e-4
    named = dict(zip([n for n, _p in model.named_parameters()], grads))
    flat = np.concatenate([named[".".join(p)].reshape(-1).numpy()
                           for p in tcodec.tree_paths(model.params_tree())])
    np.testing.assert_allclose(flat, jcodec.ravel_np(jgrads), atol=1e-5, rtol=1e-3)


# bfloat16: the two frameworks round the residual stream at different
# points, so router probabilities differ by up to ~0.05 (measured 0.048
# after a layer) and a token within twice that of a tie may route either
# way; a flipped token's logits (and, through attention, later tokens')
# then differ by O(1), so bf16 logits are not compared element-wise
BF16_ROUTE_MARGIN = 0.1


def test_zoo_bf16_routing_and_loss_match_reference(monkeypatch):
    """The zoo's MoE model in bfloat16: each layer routes every token whose
    top-two margin exceeds BF16_ROUTE_MARGIN as the reference does, the
    weighted aux agrees to 2^-7 relative and the loss to 5e-2 (the bf16
    limit of tests/test_torch_transformer_lm.py); the count of tokens
    under the margin and of those that route differently is reported."""
    jmodel = jzoo.custom_model(**MOE, n_micro=1, dtype=jnp.bfloat16)
    params = jtlm.init_params(np.random.default_rng(1), jmodel.cfg)
    tokens = np.random.default_rng(2).integers(0, MOE["vocab"], (2, 129)).astype(np.int32)
    jprobs, tprobs = [], []
    _jax_probs_recorder(jprobs, monkeypatch)
    _torch_probs_recorder(tprobs, monkeypatch)
    jlogits, jaux = jmodel.apply({"params": params}, jnp.asarray(tokens[:, :-1]))
    jloss = float(jzoo.loss((jlogits, jaux), jnp.asarray(tokens[:, 1:])))
    jax.effects_barrier()
    model = tzoo.custom_model(**MOE, dtype="bfloat16")
    load_variables(model, params)
    tok = torch.from_numpy(tokens).long()
    with torch.no_grad():
        logits, aux = model(tok[:, :-1])
        loss = float(tzoo.loss((logits, aux), tok[:, 1:]))
    assert logits.dtype == aux.dtype == torch.bfloat16
    assert len(jprobs) == len(tprobs) == MOE["n_layers"]
    for layer, (jp, tp) in enumerate(zip(jprobs, tprobs)):
        top2 = lambda p: np.diff(np.sort(p, axis=-1)[:, -2:], axis=-1)[:, 0]  # noqa: E731
        clear = np.minimum(top2(jp), top2(tp)) > BF16_ROUTE_MARGIN
        flips = int((tp.argmax(-1) != jp.argmax(-1)).sum())
        print(f"bf16 layer {layer}: {int((~clear).sum())} of {len(clear)} tokens within "
              f"{BF16_ROUTE_MARGIN} of a tie, {flips} routed differently")
        assert clear.sum() > len(clear) // 2
        np.testing.assert_array_equal(tp.argmax(-1)[clear], jp.argmax(-1)[clear])
    assert abs(float(aux) - float(jaux)) <= 2.0 ** -7 * abs(float(jaux))
    assert abs(loss - jloss) < 5e-2


def test_dense_zoo_forward_returns_logits_and_loss_adds_no_aux():
    model = tzoo.custom_model(vocab=64)
    load_variables(model, model.init_params(0))
    tok = torch.from_numpy(np.random.default_rng(3).integers(0, 64, (2, 65))).long()
    logits = model(tok[:, :-1])
    assert isinstance(logits, torch.Tensor) and logits.shape == (2, 64, 64)
    assert torch.equal(tzoo.loss(logits, tok[:, 1:]), ttlm.token_cross_entropy(logits, tok[:, 1:]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_remat_settings_give_the_same_gradients_bit_for_bit(dtype):
    """Recomputing an MoE layer reruns the same routing on the same
    inputs: off, full and "dots" give identical logits, aux and
    gradients."""
    params = jtlm.init_params(np.random.default_rng(5), _cfgs(dtype)[0])
    tok = torch.from_numpy(np.random.default_rng(6).integers(0, MOE["vocab"], (2, 65))).long()
    runs = []
    for kw in ({}, dict(remat=True), dict(remat=True, remat_policy="dots")):
        tree = params_from_jax(params)
        leaves = tcodec.tree_leaves(tree)
        for t in leaves:
            t.requires_grad_()
        logits, aux = ttlm.plain_forward(_cfgs(dtype, **kw)[1], tree, tok[:, :-1])
        loss = ttlm.token_cross_entropy(logits, tok[:, 1:]) + aux.float()
        runs.append((logits, aux, torch.autograd.grad(loss, leaves)))
    for logits, aux, grads in runs[1:]:
        assert torch.equal(logits, runs[0][0]) and torch.equal(aux, runs[0][1])
        assert all(torch.equal(g, w) for g, w in zip(grads, runs[0][2]))


def test_dots_saves_router_dispatch_and_combine_products(monkeypatch):
    """Under remat "dots" an MoE layer saves seven `aten.mm` outputs (q, k,
    v, the attention projection, the router logits, the dispatch and the
    combine products) and recomputes the expert FFNs (`aten.bmm`), as the
    reference's dots_with_no_batch_dims_saveable does."""
    caches = []
    contexts = ttlm.create_selective_checkpoint_contexts

    def recording_contexts(policy):
        pair = contexts(policy)
        caches.append(pair[0].storage)
        return pair

    monkeypatch.setattr(ttlm, "create_selective_checkpoint_contexts", recording_contexts)
    _jcfg, tcfg = _cfgs("bfloat16", remat=True, remat_policy="dots")
    tree = params_from_jax(ttlm.init_params(np.random.default_rng(8), tcfg))
    for t in tcodec.tree_leaves(tree):
        t.requires_grad_()
    tok = torch.from_numpy(np.random.default_rng(9).integers(0, MOE["vocab"], (2, 65))).long()
    logits, aux = ttlm.plain_forward(tcfg, tree, tok[:, :-1])
    saved = {}  # the policy's cache: the op outputs it kept, by op
    for cache in caches:
        for key, entries in cache.items():
            for out in entries.values():
                if isinstance(out, torch.Tensor) or hasattr(out, "val"):
                    saved[str(key)] = saved.get(str(key), 0) + 1
    assert saved == {"aten.mm.default": 7 * MOE["n_layers"]}
    (ttlm.token_cross_entropy(logits, tok[:, 1:]) + aux.float()).backward()


VOCAB, SEQ = 64, 24


def _final_loss(model, params, path):
    with RecordIOReader(path) as r:
        records = list(r.read_range(0, 64))
    feats, labels = tzoo.dataset_fn(records, "training")
    load_variables(model, params)
    with torch.no_grad():
        outputs = model(torch.from_numpy(feats).long())
    return float(tzoo.loss(outputs, torch.from_numpy(labels).long()))


def test_moe_zoo_job_trains(tmp_path):
    """The reference's MoE zoo job (tests/test_transformer_zoo_job.py:94)
    in the port: `custom_model(vocab=64, n_experts=2)` trains in-process
    over 256 records of 24 tokens (tasks of 128, 3 epochs, b32) and its
    loss on the first 64 records falls below half of chance (ln 64)."""
    path = str(tmp_path / "tokens.rio")
    write_learnable_token_records(path, 256, SEQ, VOCAB)
    dispatcher = TaskDispatcher({path: 256}, {}, {}, 128, 3)
    model = tzoo.custom_model(vocab=VOCAB, n_experts=2)
    assert model.cfg.n_experts == 2
    spec = spec_from_module(tzoo, model=model)
    servicer, _eval, _ckpt = build_job(spec, dispatcher, grads_to_wait=1)
    worker = Worker(0, InProcessMaster(servicer), spec, minibatch_size=32, device="cpu")
    assert worker.run()
    worker.close()
    assert dispatcher.finished()
    params, _aux, version = servicer.get_params_copy()
    assert version == servicer.exactness()["applied_update_steps"] == 3 * 256 // 32
    final = _final_loss(model, params, path)
    assert final < 0.5 * math.log(VOCAB), f"loss {final:.3f} did not fall"


@pytest.mark.parametrize("window", [0, 4], ids=["per-step", "window"])
def test_moe_job_matches_the_reference_job(tmp_path, window):
    """The MoE zoo model (4 experts, float32) in an in-process job,
    per-step and at W = 4 (float32 syncs), against the reference's same
    job from the same init over the same task order (2 tasks of 4
    minibatches of 2 x 64 tokens): versions equal, parameters within
    1e-4, task losses within 1e-5 (tests/test_torch_job.py's limits)."""
    path = str(tmp_path / "tokens.rio")
    write_learnable_token_records(path, 16, 64, MOE["vocab"], seed=2)
    init = jtlm.init_params(np.random.default_rng(11), jzoo.custom_model(**MOE).cfg)
    worker_kw = dict(local_updates=window, sync_dtype="float32") if window else {}
    jdispatcher = JDispatcher({path: 16}, {}, {}, 8, 1, shuffle_seed=3)
    jspec = jspec_from_module(jzoo, model=jzoo.custom_model(**MOE))
    jservicer = JServicer(1, JPSOptimizer(jzoo.optimizer()), task_dispatcher=jdispatcher,
                          init_params=init)
    jworker = JWorker(0, JInProcessMaster(jservicer), jspec, minibatch_size=2, **worker_kw)
    assert jworker.run()
    jworker.close()
    jparams, _aux, jversion = jservicer.get_params_copy()

    dispatcher = TaskDispatcher({path: 16}, {}, {}, 8, 1, shuffle_seed=3)
    spec = spec_from_module(tzoo, model=tzoo.custom_model(**MOE))
    servicer, _eval, _ckpt = build_job(spec, dispatcher, grads_to_wait=1, init_params=init)
    worker = Worker(0, InProcessMaster(servicer), spec, minibatch_size=2, device="cpu",
                    **worker_kw)
    assert worker.run()
    worker.close()
    params, _aux, version = servicer.get_params_copy()
    assert version == jversion == 8
    assert servicer.exactness()["applied_update_steps"] == version
    assert worker.steps_computed == worker.steps_accepted == version
    moved = tcodec.ravel_np(params) - tcodec.ravel_np(init)
    for leaf in ("router", "ew1", "ew2"):
        assert np.abs(params["layers"][leaf] - init["layers"][leaf]).max() > 0, leaf
    assert np.abs(moved).max() > 0
    np.testing.assert_allclose(
        tcodec.ravel_np(params), jcodec.ravel_np(jparams), atol=1e-4, rtol=0
    )
    np.testing.assert_allclose(worker.task_losses, jworker.task_losses, atol=1e-5)
