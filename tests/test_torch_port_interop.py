"""PyTorch port: reference ``.pth`` interop and the numpy threefry against
the JAX package on the CPU -- ``threefry.uniform`` / ``split`` /
``PRNGKey`` against ``jax.random`` bit for bit, the export of the committed
checkpoint array for array, ``.pth`` files written by either package read
by the other bit for bit, and the eps of a ``.pth``-loaded model against
the JAX package's on the same file.

Tolerances of the eps checks are the port's model tests': 1e-5 of max
|eps| at n_feat 8, 1e-4 abs at full width (``test_torch_port_model.py``).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from camels_diffusion_model_tpu.models import ContextUnet as JaxContextUnet
from camels_diffusion_model_tpu.models.fold_bn import fold_inference
from camels_diffusion_model_tpu.utils import torch_interop as jax_interop
from camels_diffusion_model_tpu_torch.models.context_unet import ContextUnet
from camels_diffusion_model_tpu_torch.serving import load_model
from camels_diffusion_model_tpu_torch.training.checkpoints import load_variables
from camels_diffusion_model_tpu_torch.utils import threefry, torch_interop
from camels_diffusion_model_tpu_torch.utils.weights import to_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "artifacts", "certification", "model", "train_state.msgpack")


# ---- threefry ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 1, 1, 128), (128,), (1, 1, 1, 256), (256,)])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_uniform_equals_jax_bit_for_bit(seed, shape):
    """Both halves of ``split(PRNGKey(seed))`` at the shortcut's bound for
    the shape's width, and at [0, 1)."""
    bound = 1.0 / np.sqrt(shape[-1])
    keys, jkeys = threefry.split(threefry.PRNGKey(seed)), jax.random.split(jax.random.PRNGKey(seed))
    for key, jkey in zip(keys, jkeys):
        for lo, hi in ((-bound, bound), (0.0, 1.0)):
            got = threefry.uniform(key, shape, lo, hi)
            want = np.asarray(jax.random.uniform(jkey, shape, jnp.float32, lo, hi))
            assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 4242, 2**31 - 1])
def test_prng_key_and_split_equal_jax(seed):
    key = threefry.PRNGKey(seed)
    np.testing.assert_array_equal(key, np.asarray(jax.random.PRNGKey(seed)))
    for num in (2, 3, 10):
        np.testing.assert_array_equal(threefry.split(key, num),
                                      np.asarray(jax.random.split(jax.random.PRNGKey(seed), num)))
    # a chain of splits, as the samplers replay them
    k, jk = key, jax.random.PRNGKey(seed)
    for _ in range(5):
        k, _, _ = threefry.split(k, 3)
        jk, _, _ = jax.random.split(jk, 3)
    np.testing.assert_array_equal(k, np.asarray(jk))


def test_fma_rounds_once():
    """A float64 sum on a float32 tie that a second rounding breaks the
    wrong way: 1 + 2^-24 + 2^-60 rounds up in one rounding."""
    got = threefry.fma_f32(np.float32(2.0**-24), 1.0 + 2.0**-36, 1.0)
    assert got == np.nextafter(np.float32(1.0), np.float32(2.0))
    assert threefry.fma_f32(np.float32(0.5), 3.0, 1.0) == np.float32(2.5)


# ---- export / import -----------------------------------------------------------

@pytest.fixture(scope="module")
def committed():
    return load_variables(CKPT)


def test_export_of_the_committed_checkpoint_equals_jax(committed):
    got = torch_interop.export_to_torch_state_dict(committed)
    want = jax_interop.export_to_torch_state_dict(committed)
    assert list(got) == list(want)
    assert not any("shortcut" in k for k in got)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert sum(k.endswith("num_batches_tracked") for k in got) == sum(
        k.endswith("running_mean") for k in got) > 0


def test_name_map_equals_jax():
    for levels in (2, 3):
        assert torch_interop.canonical_name_map(levels) == jax_interop.canonical_name_map(levels)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


def _assert_trees_equal(got, want):
    assert set(got) == set(want)
    for col in want:
        g, w = dict(_leaves(got[col])), dict(_leaves(want[col]))
        assert set(g) == set(w), col
        for name, value in w.items():
            assert g[name].dtype == value.dtype and g[name].shape == value.shape, name
            np.testing.assert_array_equal(g[name], value, err_msg=f"{col}{name}")


def _templates(n_feat=128, n_cfeat=6, height=64):
    jm = JaxContextUnet(n_feat=n_feat, n_cfeat=n_cfeat, height=height, levels=2)
    jt = jax.device_get(jm.init(jax.random.PRNGKey(0), np.zeros((1, height, height, 1),
                                                                  np.float32),
                                np.array([0.5], np.float32)))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        pt = to_jax_variables(ContextUnet(n_feat=n_feat, n_cfeat=n_cfeat,
                                          height=height).state_dict())
    return jm, jt, pt


@pytest.fixture(scope="module")
def full_templates():
    return _templates()


def test_jax_pth_read_by_the_port_bit_for_bit(committed, full_templates, tmp_path):
    """The JAX package writes the committed checkpoint as a ``.pth``; the
    port's import (from its own template) is the JAX import's tree, the
    threefry shortcut included."""
    _, jt, pt = full_templates
    path = str(tmp_path / "ref.pth")
    jax_interop.save_torch_checkpoint(committed, path)
    got = torch_interop.load_torch_checkpoint(pt, path)
    want = jax.device_get(jax_interop.load_torch_checkpoint(jt, path))
    _assert_trees_equal(got, want)
    assert got["params"]["init_conv"]["shortcut"]["kernel"].shape == (1, 1, 1, 128)


def test_port_pth_read_by_jax_bit_for_bit(committed, full_templates, tmp_path):
    """The reverse: the port writes, both read, and the file holds the
    reference's tensors (torch's own loader)."""
    _, jt, pt = full_templates
    path = str(tmp_path / "port.pth")
    torch_interop.save_torch_checkpoint(committed, path)
    sd = torch.load(path, weights_only=True)
    want_sd = jax_interop.export_to_torch_state_dict(committed)
    assert list(sd) == list(want_sd)
    for name, value in want_sd.items():
        np.testing.assert_array_equal(sd[name].numpy(), value, err_msg=name)
    _assert_trees_equal(jax.device_get(jax_interop.load_torch_checkpoint(jt, path)),
                        torch_interop.load_torch_checkpoint(pt, path))
    # every leaf but the shortcut is the committed checkpoint's
    back = torch_interop.load_torch_checkpoint(pt, path)
    for col in ("params", "batch_stats"):
        for name, value in _leaves(committed[col]):
            if "shortcut" not in name:
                np.testing.assert_array_equal(dict(_leaves(back[col]))[name], value)


def test_import_checks_names_and_shapes(full_templates, committed):
    _, _, pt = full_templates
    sd = torch_interop.export_to_torch_state_dict(committed)
    missing = dict(sd)
    del missing["out.3.bias"]
    with pytest.raises(KeyError, match="out.3.bias"):
        torch_interop.import_from_torch_state_dict(pt, missing)
    bad = dict(sd, **{"out.3.weight": np.zeros((1, 128, 5, 5), np.float32)})
    with pytest.raises(ValueError, match="out.3.weight"):
        torch_interop.import_from_torch_state_dict(pt, bad)


def test_shortcut_seed_draw_equals_jax():
    for seed in (0, 3):
        k, b = torch_interop.shortcut_seed_draw((1, 1, 1, 128), (128,), seed)
        kkey, bkey = jax.random.split(jax.random.PRNGKey(seed))
        np.testing.assert_array_equal(k, np.asarray(jax.random.uniform(
            kkey, (1, 1, 1, 128), jnp.float32, -1.0, 1.0)))
        np.testing.assert_array_equal(b, np.asarray(jax.random.uniform(
            bkey, (128,), jnp.float32, -1.0, 1.0)))


# ---- eps of a .pth-loaded model ------------------------------------------------

def _inputs(seed, n, height, n_cfeat):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, height, height, 1).astype(np.float32), rs.rand(n).astype(np.float32),
            rs.rand(n, n_cfeat).astype(np.float32))


@pytest.mark.parametrize("fold_bn", [False, True])
def test_tiny_pth_model_eps_matches_jax(tmp_path, fold_bn):
    """n_feat 8, 16x16: a ``.pth`` of JAX weights with non-trivial running
    statistics, loaded by each package: <= 1e-5 of max |eps|.  The
    transposed convs' flip goes through the file and back."""
    jm, jt, pt = _templates(n_feat=8, n_cfeat=3, height=16)
    rs = np.random.RandomState(2)
    jt["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (rs.rand(*a.shape) + 0.5).astype(np.float32), jt["batch_stats"])
    path = str(tmp_path / "tiny.pth")
    jax_interop.save_torch_checkpoint(jt, path)
    jvars = jax_interop.load_torch_checkpoint(jt, path)
    x, t, c = _inputs(3, 3, 16, 3)
    if fold_bn:
        jm, jvars = fold_inference(jm, jvars)
    want = np.asarray(jm.apply(jvars, x, t, c))
    port = load_model(torch_interop.load_torch_checkpoint(pt, path), "cpu", fold_bn=fold_bn)
    with torch.no_grad():
        got = port(torch.tensor(x), torch.tensor(t), torch.tensor(c)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_full_width_pth_model_eps_matches_jax(committed, full_templates, tmp_path):
    """The committed checkpoint through a ``.pth``, folded as the
    comparison CLI serves it: <= 1e-4 abs; and the port's model from the
    ``.pth`` is the ``.msgpack`` model with the threefry shortcut put in."""
    jm, jt, pt = full_templates
    path = str(tmp_path / "ref.pth")
    torch_interop.save_torch_checkpoint(committed, path)
    fm, fv = fold_inference(jm, jax_interop.load_torch_checkpoint(jt, path))
    x, t, c = _inputs(4, 2, 64, 6)
    want = np.asarray(fm.apply(fv, x, t, c))
    port = load_model(torch_interop.load_torch_checkpoint(pt, path), "cpu")
    seeded = {"params": {**committed["params"]}, "batch_stats": committed["batch_stats"]}
    kernel, bias = torch_interop.shortcut_seed_draw((1, 1, 1, 128), (128,))
    seeded["params"]["init_conv"] = {**committed["params"]["init_conv"],
                                     "shortcut": {"kernel": kernel, "bias": bias}}
    same = load_model(seeded, "cpu")
    with torch.no_grad():
        got = port(torch.tensor(x), torch.tensor(t), torch.tensor(c))
        torch.testing.assert_close(same(torch.tensor(x), torch.tensor(t), torch.tensor(c)),
                                   got, rtol=0, atol=0)
    assert np.abs(got.numpy() - want).max() <= 1e-4
