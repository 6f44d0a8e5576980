"""The port's LM track (``launch/train.py --track lm``) against the JAX
package, one step per config of src/repro/configs/, reduced, JAX's weights
carried into the port: the loss of ``lm_loss`` and its gradient against
``jax.value_and_grad`` of the reference's loss
(src/repro/launch/train.py:148-154, written out here: it is a closure of
the reference's ``train_lm``) at 1e-4.  The encoder-decoder gets frames
drawn from the seed (the reference's encoder reads them).  rwkv6-7b and
zamba2-1.2b sit at their measured one-ulp noise floor (the tests named
*noise_floor): JAX's own gradient moves by 1.5e-5 and 2.4e-5 when its
embedding moves by one ulp, and the port is within twice that."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_seq import np_tree, pair_of, ulp_noise  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.launch.train import lm_loss, lm_step  # noqa: E402
from repro_torch.models.common import ParamTree, flatten_tree  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402

LM_TOL = dict(rtol=1e-4, atol=1e-4)
NOISY = ("zamba2-1.2b", "rwkv6-7b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes on
    the same cores, and small ops then spend their time in thread
    hand-offs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_loss(jm, params, inputs, tokens):
    """The reference's LM loss (src/repro/launch/train.py:148-154)."""
    h, aux = jm.forward_with_aux(params, {**inputs, "tokens": tokens[:, :-1]})
    logits = jm.logits(params, h)
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
    nll = -jnp.take_along_axis(logp, tokens[:, 1:, None], -1)[..., 0]
    return jnp.mean(nll) + 1e-2 * aux


def _inputs(pair):
    jin, tin = pair.inputs(2, 17, seed=3, patches=False)
    frames = torch.from_numpy(tin["frames"]) if "frames" in tin else None
    return jin.pop("tokens"), jin, torch.from_numpy(tin["tokens"]), frames


def _lm_model(pair):
    """The pair's model as ``lm_setup`` builds it: the plain attention
    (every pass of the track trains; the kernel has no backward)."""
    return dataclasses.replace(pair.m, use_kernels=False)


def _port_grads(pair, tokens, frames):
    tree = ParamTree(pair.p)
    loss = lm_loss(_lm_model(pair), tree.tree, tokens, frames)
    names = [n for n, _ in tree.named_parameters()]
    grads = torch.autograd.grad(loss, list(tree.parameters()),
                                allow_unused=True)
    return float(loss.detach()), {
        n: (torch.zeros_like(p) if g is None else g).numpy()
        for n, p, g in zip(names, tree.parameters(), grads)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_loss_and_gradients_match_jax(arch):
    pair = pair_of(arch)
    jtok, jin, tokens, frames = _inputs(pair)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(pair.jm, p, jin, jtok)))(pair.jp)
    jgrads = dict(flatten_tree(np_tree(jgrads)))
    loss, grads = _port_grads(pair, tokens, frames)
    np.testing.assert_allclose(loss, float(want), **LM_TOL)
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g, jgrads[name], err_msg=name, **LM_TOL)
    # the step itself (at a constant lr: the track's cosine schedule
    # starts its warm-up at 0): the same loss, parameters finite, moved
    tree = ParamTree(_clone(pair.p))
    opt = make_optimizer("adamw", lr=1e-3)
    before = [p.detach().clone() for p in tree.parameters()]
    _, step_loss = lm_step(_lm_model(pair), tree, opt,
                           opt.init(list(tree.parameters())), tokens, frames)
    assert float(step_loss) == loss
    assert all(torch.isfinite(p).all() for p in tree.parameters())
    assert any(not torch.equal(a, b) for a, b in zip(before,
                                                     tree.parameters()))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_clone(v) for v in tree]
    return tree.detach().clone()


@pytest.mark.parametrize("arch", NOISY)
def test_lm_gradient_noise_floor(arch):
    """JAX's own gradient moves by more than 5e-6 when its embedding moves
    by one ulp, and the port's distance from it is within twice that."""
    pair = pair_of(arch)
    jtok, jin, tokens, frames = _inputs(pair)
    grad = jax.jit(jax.grad(lambda p: _jax_loss(pair.jm, p, jin, jtok)))

    def flat(embed):
        g = grad({**pair.jp, "embed": jnp.asarray(embed)})
        return np.concatenate([np.ravel(x)
                               for _, x in flatten_tree(np_tree(g))])

    noise = ulp_noise(flat, np.asarray(pair.jp["embed"]))
    jgrads = dict(flatten_tree(np_tree(grad(pair.jp))))
    _, grads = _port_grads(pair, tokens, frames)
    got = max(float(np.abs(g - jgrads[n]).max()) for n, g in grads.items())
    assert noise > 5e-6
    assert got < 2 * noise < LM_TOL["atol"]
