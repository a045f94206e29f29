"""The reference's large and xl transformer configs in the port, on the
CPU: head dim 128, per-layer rematerialization (off, full, "dots")
against the reference's `plain_forward` / `build_loss_fn` under
`jax.checkpoint`, the "dots" policy's saved tensors, the configs'
`--model_params` strings, and in-process per-step and window jobs
against the reference's jobs.

The large config is cut in depth and width but keeps the head dim of
128: d_model 256, 2 heads, d_ff 512, 2 layers, vocab 256, batch 2 x L
128. The xl cut keeps its head dim of 128 and its d_ff = 4 d_model:
d_model 256, 2 heads, d_ff 1024, 2 layers, under remat "dots".

Tolerances are those of tests/test_torch_transformer_lm.py: float32
logits and loss 1e-4, flat gradients 1e-5 absolute + 1e-3 relative;
bfloat16 5e-2 absolute on logits and loss and 5e-2 of the gradients'
largest magnitude. Jobs: those of tests/test_torch_window.py.
"""

import collections

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
from elasticdl_tpu.testing import InProcessMaster as JInProcessMaster
from elasticdl_tpu.worker.worker import Worker as JWorker
from elasticdl_tpu_torch.api.model_spec import parse_model_params
from elasticdl_tpu_torch.api.model_spec_helpers import spec_from_module
from elasticdl_tpu_torch.common import codec as tcodec
from elasticdl_tpu_torch.convert import params_from_jax
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.models import transformer_lm as ttlm
from elasticdl_tpu_torch.models import transformer_lm_zoo as tzoo
from elasticdl_tpu_torch.models.record_codec import write_learnable_token_records
from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.testing import InProcessMaster, build_job
from elasticdl_tpu_torch.worker.worker import Worker
from _torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

CUT = dict(vocab=256, d_model=256, n_heads=2, d_ff=512, n_layers=2)
BATCH, SEQ = 2, 128
# the reference's large config (bench_transformer.py:172-186) as a
# --model_params string
LARGE_PARAMS = ("vocab=8192,d_model=1024,n_heads=8,d_ff=4096,n_layers=16,n_micro=1,"
                "dtype=bfloat16,remat=True,remat_policy=dots")
# the reference's xl config (bench_transformer.py:211-221)
XL_PARAMS = ("vocab=8192,d_model=2048,n_heads=16,d_ff=8192,n_layers=8,n_micro=1,"
             "dtype=bfloat16,remat=True,remat_policy=dots")
XL_CUT = dict(CUT, d_ff=1024)
REMAT = {"off": dict(remat=False), "full": dict(remat=True, remat_policy=""),
         "dots": dict(remat=True, remat_policy="dots")}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(dtype, remat, cut=CUT):
    return (
        jtlm.TransformerConfig(**cut, n_micro=1, dtype=JDT[dtype], **REMAT[remat]),
        ttlm.TransformerConfig(**cut, n_micro=1, dtype=TDT[dtype], **REMAT[remat]),
    )


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, CUT["vocab"], (BATCH, SEQ + 1)).astype(np.int32)


def _jax_step(cfg, params, tokens):
    """Logits from `plain_forward`, loss and gradients from
    `build_loss_fn` on a one-device mesh (its plain_forward path)."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1, 1), jtlm.MESH_AXES)
    loss_fn = jtlm.build_loss_fn(cfg, mesh)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    loss, grads = jax.value_and_grad(loss_fn)(jparams, jnp.asarray(tokens))
    logits, _aux = jtlm.plain_forward(cfg, jparams, jnp.asarray(tokens[:, :-1]))
    return np.asarray(jnp.asarray(logits, jnp.float32)), float(loss), jcodec.ravel_np(grads)


def _torch_step(cfg, params, tokens):
    tree = params_from_jax(params)
    leaves = tcodec.tree_leaves(tree)
    for t in leaves:
        t.requires_grad_()
    tok = torch.from_numpy(tokens).long()
    logits, _aux = ttlm.plain_forward(cfg, tree, tok[:, :-1])
    loss = ttlm.token_cross_entropy(logits, tok[:, 1:])
    grads = torch.autograd.grad(loss, leaves)
    return logits, float(loss.detach()), torch.cat([g.reshape(-1) for g in grads]).numpy()


def _check_step(dtype, remat, cut=CUT, seed=1):
    jcfg, tcfg = _cfgs(dtype, remat, cut)
    assert tcfg.head_dim == 128 and fa.kernels_take((BATCH, SEQ, 2, 128), TDT[dtype])
    params = jtlm.init_params(np.random.default_rng(seed), jcfg)
    tokens = _tokens(seed=seed + 1)
    jl, jloss, jg = _jax_step(jcfg, params, tokens)
    tl, tloss, tg = _torch_step(tcfg, params, tokens)
    assert tl.dtype == TDT[dtype]
    tl = tl.detach().float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
        assert abs(tloss - jloss) < 1e-4
        np.testing.assert_allclose(tg, jg, atol=1e-5, rtol=1e-3)
    else:
        np.testing.assert_allclose(tl, jl, atol=5e-2, rtol=5e-2)
        assert abs(tloss - jloss) < 5e-2
        np.testing.assert_allclose(tg, jg, atol=5e-2 * np.abs(jg).max())


@pytest.mark.parametrize("remat", list(REMAT))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_loss_grads_match_reference_under_remat(dtype, remat):
    _check_step(dtype, remat)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xl_cut_logits_loss_grads_match_reference_under_dots(dtype):
    """xl's width ratio (d_ff = 4 d_model) at head dim 128, remat "dots"."""
    _check_step(dtype, "dots", XL_CUT, seed=21)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_settings_give_the_same_gradients_bit_for_bit(dtype):
    """Recomputing a layer runs the same ops on the same inputs, so off,
    full and "dots" give identical logits, loss and gradients."""
    params = jtlm.init_params(np.random.default_rng(3), _cfgs(dtype, "off")[0])
    tokens = _tokens(seed=4)
    runs = [_torch_step(_cfgs(dtype, remat)[1], params, tokens) for remat in REMAT]
    for logits, loss, grads in runs[1:]:
        assert torch.equal(logits, runs[0][0])
        assert loss == runs[0][1]
        assert grads.tobytes() == runs[0][2].tobytes()


def _saved_bytes(cfg, params, tokens, monkeypatch):
    """Bytes the forward leaves for the backward: tensors packed by the
    autograd graph (outside checkpointed layers), the checkpointed
    layers' inputs, and the "dots" policy's cache of saved op outputs;
    each storage counted once. Also returns the cached ops' names."""
    storages = {}

    def keep(t):
        if isinstance(t, torch.Tensor):
            storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()

    checkpoint, contexts = ttlm.checkpoint, ttlm.create_selective_checkpoint_contexts
    caches = []

    def recording_checkpoint(fn, *args, **kw):
        for a in args:
            keep(a)
        return checkpoint(fn, *args, **kw)

    def recording_contexts(policy):
        pair = contexts(policy)
        caches.append(pair[0].storage)
        return pair

    monkeypatch.setattr(ttlm, "checkpoint", recording_checkpoint)
    monkeypatch.setattr(ttlm, "create_selective_checkpoint_contexts", recording_contexts)
    tree = params_from_jax(params)
    for t in tcodec.tree_leaves(tree):
        t.requires_grad_()
    tok = torch.from_numpy(tokens).long()

    def pack(t):
        keep(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        logits, _aux = ttlm.plain_forward(cfg, tree, tok[:, :-1])
        loss = ttlm.token_cross_entropy(logits, tok[:, 1:])
    ops = collections.Counter()
    for cache in caches:
        for key, entries in cache.items():
            for out in entries.values():
                if isinstance(out, torch.Tensor) or hasattr(out, "val"):
                    ops[str(key)] += 1
                    keep(getattr(out, "val", out))
    loss.backward()
    return sum(storages.values()), ops


def test_dots_saves_the_six_projections_a_layer(monkeypatch):
    """Saved bytes order full < dots < off; "dots" keeps the outputs of the
    six `x @ w` products of every layer (the `aten.mm` calls) and nothing
    else, and full remat keeps only each layer's inputs."""
    params = jtlm.init_params(np.random.default_rng(5), _cfgs("bfloat16", "off")[0])
    tokens = _tokens(seed=6)
    saved, ops = {}, {}
    for remat in REMAT:
        with monkeypatch.context() as m:
            saved[remat], ops[remat] = _saved_bytes(_cfgs("bfloat16", remat)[1], params, tokens, m)
    assert saved["full"] < saved["dots"] < saved["off"], saved
    assert ops["off"] == {} and ops["full"] == {}
    assert set(ops["dots"]) == {"aten.mm.default"}
    assert ops["dots"]["aten.mm.default"] == 6 * CUT["n_layers"]
    # the six outputs of a layer: q, k, v and the attention projection
    # [B*L, d_model] each, w1's [B*L, d_ff] and w2's [B*L, d_model]
    d, ff = CUT["d_model"], CUT["d_ff"]
    six = BATCH * SEQ * (5 * d + ff) * 2
    assert saved["dots"] - saved["full"] >= CUT["n_layers"] * six


def test_large_model_params_build_the_reference_large_config():
    """The reference's large `--model_params` string builds the zoo model
    with 218,137,600 parameters (an 872.6 MB float32 flat vector), head
    dim 128, remat "dots", bf16 compute; on the meta device, so nothing
    is allocated."""
    params = parse_model_params(LARGE_PARAMS)
    assert params["remat"] is True and params["remat_policy"] == "dots"
    with torch.device("meta"):
        model = tzoo.custom_model(**params)
    cfg = model.cfg
    assert (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.n_layers) == (1024, 8, 128, 4096, 16)
    assert cfg.dtype == torch.bfloat16 and cfg.remat and cfg.remat_policy == "dots"
    assert cfg.n_micro == 1
    n = sum(p.numel() for p in model.parameters())
    shapes = ttlm.param_shapes(cfg)
    sizes = [np.prod(shapes[k]) for k in ("embed", "head", "ln_f")]
    sizes += [np.prod(s) for s in shapes["layers"].values()]
    assert n == sum(int(x) for x in sizes) == 218_137_600
    assert all(p.device.type == "meta" for p in model.parameters())
    # the reference's config agrees
    jcfg = jzoo.custom_model(**params).cfg
    assert jcfg.remat and jcfg.remat_policy == "dots" and jcfg.head_dim == 128
    assert fa.kernels_take((16, 1024, 8, 128), torch.bfloat16)


def test_xl_model_params_build_the_reference_xl_config():
    """xl's `--model_params` string builds the zoo model with 436,242,432
    parameters (on the meta device, so nothing is allocated): 16 heads of
    128, d_ff 8192, 8 layers, remat "dots", bf16, as the reference's
    config from the same string; its attention shape [8, 1024, 16, 128]
    takes the D = 128 kernels."""
    params = parse_model_params(XL_PARAMS)
    with torch.device("meta"):
        model = tzoo.custom_model(**params)
    cfg = model.cfg
    assert (cfg.vocab, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.n_layers) == (
        8192, 2048, 16, 128, 8192, 8)
    assert cfg.dtype == torch.bfloat16 and cfg.remat and cfg.remat_policy == "dots"
    assert cfg.n_experts == 0 and cfg.n_micro == 1
    shapes = ttlm.param_shapes(cfg)
    sizes = [np.prod(shapes[k]) for k in ("embed", "head", "ln_f")]
    sizes += [np.prod(s) for s in shapes["layers"].values()]
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(x) for x in sizes) == 436_242_432
    assert all(p.device.type == "meta" for p in model.parameters())
    jcfg = jzoo.custom_model(**params).cfg
    for key in ("vocab", "d_model", "n_heads", "d_ff", "n_layers", "n_experts", "remat",
                "remat_policy"):
        assert getattr(jcfg, key) == getattr(cfg, key), key
    assert fa.kernels_take((8, 1024, 16, 128), torch.bfloat16)


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        ttlm.TransformerConfig(**CUT, remat=True, remat_policy="offload")


@pytest.fixture
def records(tmp_path):
    path = str(tmp_path / "tokens.rio")
    write_learnable_token_records(path, 16, SEQ, CUT["vocab"], seed=2)
    return path


@pytest.mark.parametrize("window", [0, 4], ids=["per-step", "window"])
def test_large_cut_job_matches_the_reference_job(records, window):
    """The cut config with remat "dots" (float32) in an in-process job,
    per-step and at W = 4, against the reference's same job from the same
    init over the same task order (2 tasks of 4 minibatches): versions
    equal, params within 1e-4, task losses within 1e-5."""
    model_kw = dict(CUT, remat=True, remat_policy="dots")
    init = jtlm.init_params(np.random.default_rng(11), jzoo.custom_model(**model_kw).cfg)
    worker_kw = dict(local_updates=window, sync_dtype="float32") if window else {}
    jdispatcher = JDispatcher({records: 16}, {}, {}, 8, 1, shuffle_seed=3)
    jspec = jspec_from_module(jzoo, model=jzoo.custom_model(**model_kw))
    jservicer = JServicer(1, JPSOptimizer(jzoo.optimizer()), task_dispatcher=jdispatcher,
                          init_params=init)
    jworker = JWorker(0, JInProcessMaster(jservicer), jspec, minibatch_size=BATCH, **worker_kw)
    assert jworker.run()
    jworker.close()
    jparams, _aux, jversion = jservicer.get_params_copy()

    dispatcher = TaskDispatcher({records: 16}, {}, {}, 8, 1, shuffle_seed=3)
    spec = spec_from_module(tzoo, model=tzoo.custom_model(**model_kw))
    servicer, _eval, _ckpt = build_job(spec, dispatcher, grads_to_wait=1, init_params=init)
    worker = Worker(0, InProcessMaster(servicer), spec, minibatch_size=BATCH, device="cpu",
                    **worker_kw)
    assert worker.run()
    worker.close()
    params, _aux, version = servicer.get_params_copy()
    assert version == jversion == 16 // BATCH
    assert servicer.exactness()["applied_update_steps"] == version
    assert worker.steps_computed == worker.steps_accepted == version
    np.testing.assert_allclose(
        tcodec.ravel_np(params), jcodec.ravel_np(jparams), atol=1e-4, rtol=0
    )
    np.testing.assert_allclose(worker.task_losses, jworker.task_losses, atol=1e-5)
