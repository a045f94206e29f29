"""The port's image zoo against the reference's flax models, on the CPU.

Each model runs the same numpy batch (uint8 NHWC images, integer
labels) from the reference's own init, converted by
`convert.variables_from_jax`: in train mode the logits, the gradient of
the mean softmax cross entropy and the new `batch_stats`; in eval mode
the logits over running statistics that a train step moved. ResNet-50
runs at `stage_sizes=(1, 1, 1, 1)` and 32 px.

Float32 tolerance: max |port - reference| <= 1e-4 x max |reference| for
each output (measured 5e-7 to 2e-5: the same formulas, other summation
orders in the convs and the batch statistics).

bfloat16 ResNet (convs and BatchNorm outputs rounded to bf16, f32
statistics), batch 8: the two frameworks' bf16 convs accumulate in other
orders, and one rounding flip moves a BatchNorm over 8 values at 1x1
spatial size. So the port is held (a) to the reference's bf16 within a
norm-relative limit per output, logits 0.03, gradient 0.3, batch stats
1e-3 (measured over 4 seeds: at most 0.021 / 0.202 / 0.0005), and (b) to
be no further from the reference's float32 than 2x the reference's own
bf16 is (measured 1.08x-1.55x: the port's bf16 sits a little further
from float32 than XLA:CPU's).

Init is drawn with numpy, not jax.random: the tree, shapes and dtypes
equal flax's, and the kernels' statistics are lecun_normal's.
"""

import functools
import inspect
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax import lax  # noqa: E402

from elasticdl_tpu.models import cifar10_functional_api as jcifar  # noqa: E402
from elasticdl_tpu.models import cifar10_subclass as jcifar_sub  # noqa: E402
from elasticdl_tpu.models import mnist_functional_api as jmnist  # noqa: E402
from elasticdl_tpu.models import mnist_subclass as jmnist_sub  # noqa: E402
from elasticdl_tpu.models import resnet50_subclass as jresnet  # noqa: E402
from elasticdl_tpu_torch.api.model_spec import new_aux_values, takes_train_kwarg  # noqa: E402
from elasticdl_tpu_torch.common import codec  # noqa: E402
from elasticdl_tpu_torch.convert import load_variables, variables_from_jax  # noqa: E402
from elasticdl_tpu_torch.models import cifar10_functional_api as tcifar  # noqa: E402
from elasticdl_tpu_torch.models import cifar10_subclass as tcifar_sub  # noqa: E402
from elasticdl_tpu_torch.models import image_layers  # noqa: E402
from elasticdl_tpu_torch.models import mnist_functional_api as tmnist  # noqa: E402
from elasticdl_tpu_torch.models import mnist_subclass as tmnist_sub  # noqa: E402
from elasticdl_tpu_torch.models import resnet50_subclass as tresnet  # noqa: E402
from _torch_threads import two_torch_threads  # noqa: E402,F401 (autouse fixture)

B = 4
F32_REL = 1e-4
BF16_BATCH = 8
BF16_LIMITS = {"logits": 0.03, "grad": 0.3, "aux": 1e-3}
BF16_FROM_F32_RATIO = 2.0

# name -> (reference model, port model, image shape); ResNet cut to one
# block a stage at 32 px
MODELS = {
    "mnist_functional_api": (jmnist.custom_model, tmnist.custom_model, jmnist.IMAGE_SHAPE),
    "mnist_subclass": (jmnist_sub.custom_model, tmnist_sub.custom_model, jmnist.IMAGE_SHAPE),
    "cifar10_functional_api": (jcifar.custom_model, tcifar.custom_model, jcifar.IMAGE_SHAPE),
    "cifar10_subclass": (jcifar_sub.custom_model, tcifar_sub.custom_model, jcifar.IMAGE_SHAPE),
    "resnet50": (
        lambda: jresnet.ResNet50(stage_sizes=(1, 1, 1, 1)),
        lambda: tresnet.ResNet50(stage_sizes=(1, 1, 1, 1)),
        (32, 32, 3),
    ),
}


def _batch(shape, seed=0, b=B):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b,) + shape).astype(np.uint8), rng.integers(0, 10, b)


def _has_train(jmodel) -> bool:
    """The reference worker's `_takes_train_kwarg`."""
    return "train" in inspect.signature(jmodel.__call__).parameters


def _reference(jmodel, variables, x, y, train):
    """(logits, gradient tree, new batch_stats) of the flax model, jitted.
    The MNIST models take float images in [0, 1] (their dataset_fn
    decodes them on the host); the port's take the uint8 and divide on
    the device, which gives the same values."""
    takes_train = _has_train(jmodel)
    xin = jnp.asarray(x) if takes_train else jnp.asarray(x, jnp.float32) / 255.0
    aux = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(params):
        kw = {"train": train} if takes_train else {}
        if train and aux:
            out, new = jmodel.apply({"params": params, **aux}, xin, mutable=list(aux), **kw)
        else:
            out, new = jmodel.apply({"params": params, **aux}, xin, **kw), {}
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(out, y)), (out, new)

    (_, (out, new)), grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"]
    )
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return np.asarray(out, np.float32), to_np(grad), to_np(dict(new))


def _port(tmodel, params, aux, x, y, train):
    """The same three of the port's model (the new stats from `aux_out`)."""
    load_variables(tmodel, params, aux)
    names = [".".join(p) for p in codec.tree_paths(params)]
    leaves = [tmodel.get_parameter(n) for n in names]
    xt = torch.from_numpy(x)
    out = tmodel(xt, train=train) if takes_train_kwarg(tmodel) else tmodel(xt)
    loss = image_layers.softmax_cross_entropy(out, torch.from_numpy(y))
    grad = torch.autograd.grad(loss, leaves)
    new = []
    if train and aux:
        new = [t.numpy() for t in new_aux_values(tmodel, codec.tree_paths(aux))]
    return (out.detach().float().numpy(), torch.cat([g.reshape(-1) for g in grad]).numpy(),
            np.concatenate([n.ravel() for n in new]) if new else np.zeros(0, np.float32))


@functools.lru_cache(maxsize=None)
def _init(name):
    """The reference's init of a model of MODELS (numpy, shared by tests)."""
    jfactory, _tfactory, shape = MODELS[name]
    jmodel = jfactory()
    x = np.zeros((1,) + shape, np.uint8)
    kw = {"train": False} if _has_train(jmodel) else {}
    xin = x if kw else x.astype(np.float32)
    v = jax.jit(lambda x: jmodel.init(jax.random.PRNGKey(7), x, **kw))(xin)
    return jax.tree_util.tree_map(np.asarray, v)


def _rel(got, want) -> float:
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _norm_rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_flax_in_float32(name, train):
    jfactory, tfactory, shape = MODELS[name]
    jmodel = jfactory()
    variables = _init(name)
    x, y = _batch(shape)
    if not train and "batch_stats" in variables:
        # eval reads the running statistics: move them off their init
        rng = np.random.default_rng(3)
        variables = {**variables, "batch_stats": jax.tree_util.tree_map(
            lambda a: (a + rng.uniform(-0.5, 0.5, a.shape)).astype(np.float32),
            variables["batch_stats"])}
    params, aux = variables_from_jax(variables)
    out, grad, new = _reference(jmodel, variables, x, y, train)
    got_out, got_grad, got_new = _port(tfactory(), params, aux, x, y, train)
    assert _rel(got_out, out) <= F32_REL
    assert _rel(got_grad, codec.ravel_np(grad)) <= F32_REL
    if train and aux:
        assert got_new.size and _rel(got_new, codec.ravel_np(new)) <= F32_REL
    else:
        assert not new and not got_new.size


def test_resnet_bfloat16_matches_flax_bfloat16():
    shape = (32, 32, 3)
    variables = _init("resnet50")
    params, aux = variables_from_jax(variables)
    x, y = _batch(shape, b=BF16_BATCH)
    ref = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        out, grad, new = _reference(
            jresnet.ResNet50(stage_sizes=(1, 1, 1, 1), compute_dtype=dtype), variables, x, y, True
        )
        ref[dtype] = (out, codec.ravel_np(grad), codec.ravel_np(new))
    model = tresnet.ResNet50(stage_sizes=(1, 1, 1, 1), compute_dtype=torch.bfloat16)
    got = _port(model, params, aux, x, y, True)
    for i, what in enumerate(("logits", "grad", "aux")):
        assert _norm_rel(got[i], ref[jnp.bfloat16][i]) <= BF16_LIMITS[what], what
        own = _norm_rel(ref[jnp.bfloat16][i], ref[jnp.float32][i])
        assert _norm_rel(got[i], ref[jnp.float32][i]) <= BF16_FROM_F32_RATIO * own, what
    # bf16 compute over f32 parameters and f32 statistics; the head in f32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers())
    assert model(torch.from_numpy(x), train=False).dtype == torch.float32
    assert tresnet.custom_model(bfloat16=True).compute_dtype == torch.bfloat16


@pytest.mark.parametrize("name", list(MODELS))
def test_init_has_flax_tree_and_lecun_normal_statistics(name):
    """The port's init: flax's tree, shapes and dtypes; aux, biases and
    BatchNorm scales exactly flax's (a bottleneck's last scale 0); every
    kernel a truncated normal (|z| < 2 standard deviations) whose standard
    deviation is lecun_normal's sqrt(1 / fan_in) within 10% where it has
    2,000 or more elements."""
    _jfactory, tfactory, _shape = MODELS[name]
    variables = _init(name)
    want_params, want_aux = variables_from_jax(variables)
    model = tfactory()
    params, aux = model.init_params(5), model.init_aux()
    assert codec.tree_paths(params) == codec.tree_paths(want_params)
    assert [(a.shape, a.dtype) for a in codec.tree_leaves(params)] == [
        (a.shape, a.dtype) for a in codec.tree_leaves(want_params)
    ]
    assert codec.tree_paths(aux) == codec.tree_paths(want_aux)
    for leaf, want in zip(codec.tree_leaves(aux), codec.tree_leaves(want_aux)):
        assert leaf.dtype == want.dtype and leaf.tobytes() == want.tobytes()
    # the module's own parameter names are the tree's paths
    assert sorted(n for n, _ in model.named_parameters()) == sorted(
        ".".join(p) for p in codec.tree_paths(params)
    )
    assert codec.ravel_np(model.init_params(5)).tobytes() == codec.ravel_np(params).tobytes()
    for path, leaf, want in zip(codec.tree_paths(params), codec.tree_leaves(params),
                                codec.tree_leaves(want_params)):
        if path[-1] == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
            assert np.abs(leaf).max() < 2 * std
            if leaf.size >= 2000:
                assert abs(leaf.std() / np.sqrt(1.0 / fan_in) - 1) < 0.1, path
        else:  # biases, BatchNorm scales: constants, flax's exactly
            assert leaf.tobytes() == want.tobytes(), path
    if name == "resnet50":
        assert not params["Bottleneck_0"]["BatchNorm_2"]["scale"].any()
        assert params["Bottleneck_0"]["BatchNorm_3"]["scale"].all()


@pytest.mark.parametrize("size, window, stride", [
    (64, 7, 2), (32, 3, 2), (32, 3, 1), (28, 3, 1), (16, 1, 2), (7, 3, 2), (5, 2, 2),
])
def test_same_padding_is_laxs(size, window, stride):
    assert image_layers.same_pads(size, window, stride) == tuple(
        lax.padtype_to_pads((size,), (window,), (stride,), "SAME")[0]
    )
