"""PyTorch port: the in-package msgpack decoder and encoder, the checkpoint
loader and the weight conversion, against flax on the committed checkpoint;
weights files and train checkpoints across the two packages, both ways."""

import os

import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from camels_diffusion_model_tpu.serving import _md5
from camels_diffusion_model_tpu_torch import _msgpack
from camels_diffusion_model_tpu_torch.training.checkpoints import load_variables, md5
from camels_diffusion_model_tpu_torch.utils.weights import from_jax_variables, to_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "artifacts", "certification", "model", "train_state.msgpack")


@pytest.fixture(scope="module")
def port_variables():
    return load_variables(CKPT)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def test_committed_checkpoint_matches_flax_exactly(port_variables):
    """Tensor for tensor, bit-exact, against flax ``from_bytes`` (the
    restore ``load_model_weights`` runs) and flax's raw ``msgpack_restore``
    (which proves no leaf of params/batch_stats is missing)."""
    with open(CKPT, "rb") as f:
        data = f.read()
    restored = serialization.from_bytes(port_variables, data)
    raw = serialization.msgpack_restore(data)
    for col in ("params", "batch_stats"):
        ours = dict(_leaves(port_variables[col]))
        assert set(ours) == set(dict(_leaves(raw[col])))
        for name, want in _leaves(restored[col]):
            got = ours[name]
            assert got.dtype == want.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert set(port_variables) == {"params", "batch_stats"}  # opt_state dropped
    assert port_variables["params"]["init_conv"]["shortcut"]["kernel"].shape == (1, 1, 1, 128)


def test_md5_matches_jax_stamp():
    assert md5(CKPT) == _md5(CKPT) == "a76d14b581f68404198fc63f2a28f59f"


def test_from_jax_variables_carries_init_conv_shortcut(port_variables):
    """The learned 1x1 projection that ``torch_interop``'s export drops."""
    sd = from_jax_variables(port_variables)
    k = port_variables["params"]["init_conv"]["shortcut"]["kernel"]
    np.testing.assert_array_equal(
        sd["init_conv.shortcut.weight"].numpy(), np.transpose(k, (3, 2, 0, 1))
    )
    np.testing.assert_array_equal(
        sd["init_conv.shortcut.bias"].numpy(),
        port_variables["params"]["init_conv"]["shortcut"]["bias"],
    )


@pytest.mark.parametrize("name,flax_path,layout", [
    ("down1.block1.conv1.conv.weight", ("down1", "block1", "conv1", "conv", "kernel"), "oihw"),
    ("up1.upconv.weight", ("up1", "upconv", "kernel"), "iohw_flip"),
    ("up0_conv.weight", ("up0_conv", "kernel"), "iohw_flip"),
    ("timeembed1.fc2.weight", ("timeembed1", "fc2", "kernel"), "linear"),
    ("out_norm.weight", ("out_norm", "scale"), "same"),
    ("up2.block2.conv2_bn.weight", ("up2", "block2", "conv2_bn", "scale"), "same"),
])
def test_from_jax_variables_layouts(port_variables, name, flax_path, layout):
    sd = from_jax_variables(port_variables)
    a = port_variables["params"]
    for key in flax_path:
        a = a[key]
    want = {
        "oihw": lambda k: np.transpose(k, (3, 2, 0, 1)),
        "iohw_flip": lambda k: np.transpose(k[::-1, ::-1], (2, 3, 0, 1)),
        "linear": lambda k: k.T,
        "same": lambda k: k,
    }[layout](a)
    np.testing.assert_array_equal(sd[name].numpy(), want)


def test_from_jax_variables_batch_stats(port_variables):
    sd = from_jax_variables(port_variables)
    bs = port_variables["batch_stats"]["down2"]["block1"]["conv2_bn"]
    np.testing.assert_array_equal(sd["down2.block1.conv2_bn.running_mean"].numpy(), bs["mean"])
    np.testing.assert_array_equal(sd["down2.block1.conv2_bn.running_var"].numpy(), bs["var"])
    assert int(sd["down2.block1.conv2_bn.num_batches_tracked"]) == 0
    assert all(isinstance(v, torch.Tensor) for v in sd.values())


VALUES = [
    0, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63, -1, -32, -33, -128,
    -129, -2**15 - 1, -2**31 - 1, -2**63, 1.5, -2.25e300, None, True, False,
    "", "x" * 31, "y" * 32, "z" * 300, "w" * 70000, [], list(range(15)),
    list(range(16)), list(range(70000)), {}, {str(i): i for i in range(16)},
    {"nested": {"a": [1, {"b": "c"}]}},
]
ARRAYS = [
    np.arange(12, dtype=np.float32).reshape(3, 4),
    np.zeros((0, 2), np.float64),
    np.array([[1, -2]], np.int32),
    np.ones((2, 2, 2), np.uint8),
]


@pytest.mark.parametrize("value", VALUES)
def test_msgpack_decodes_msgpack_package_output(value):
    assert _msgpack.unpackb(msgpack.packb(value, use_bin_type=True)) == value


@pytest.mark.parametrize("value", VALUES)
def test_msgpack_encodes_as_the_msgpack_package(value):
    """``packb`` writes what flax's encoder, ``msgpack.packb``, writes."""
    assert _msgpack.packb(value) == msgpack.packb(value, use_bin_type=True)


@pytest.mark.parametrize("payload", [b"", b"\x00" * 5, b"\x01" * 300, b"\x02" * 70000])
def test_msgpack_bin_is_zero_copy_view(payload):
    data = msgpack.packb(payload, use_bin_type=True)
    got = _msgpack.unpackb(data)
    assert isinstance(got, memoryview) and bytes(got) == payload


@pytest.mark.parametrize("arr", ARRAYS)
def test_msgpack_encodes_flax_ndarray_ext(arr):
    tree = {"a": arr, "s": np.float32(2.5), "i": 3, "z": np.asarray(7, np.int32)}
    assert _msgpack.packb(tree) == serialization.to_bytes(tree)


def test_msgpack_reencodes_the_committed_checkpoint_byte_for_byte():
    with open(CKPT, "rb") as f:
        data = f.read()
    assert _msgpack.packb(_msgpack.unpackb(data)) == data


@pytest.mark.parametrize("arr", ARRAYS)
def test_msgpack_decodes_flax_ndarray_ext(arr):
    data = serialization.to_bytes({"a": arr, "s": np.float32(2.5), "i": 3})
    got = _msgpack.unpackb(data)
    assert got["a"].dtype == arr.dtype and got["a"].shape == arr.shape
    np.testing.assert_array_equal(got["a"], arr)
    assert got["s"] == np.float32(2.5) and got["s"].dtype == np.float32
    assert got["i"] == 3


def test_msgpack_rejects_chunked_truncated_and_trailing():
    chunked = msgpack.packb({"__msgpack_chunked_array__": True, "shape": {}})
    with pytest.raises(ValueError, match="chunked"):
        _msgpack.unpackb(chunked)
    good = msgpack.packb({"a": [1, 2, 3]})
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.unpackb(good[:-1])
    with pytest.raises(ValueError, match="trailing"):
        _msgpack.unpackb(good + b"\x00")
    with pytest.raises(ValueError, match="ext type"):
        _msgpack.unpackb(msgpack.packb(msgpack.ExtType(2, b"ab")))


# ---- weights files and train checkpoints across the two packages ----------

H, T = 16, 8


@pytest.fixture(scope="module")
def tiny_jax():
    import jax

    from camels_diffusion_model_tpu.models import ContextUnet as JaxContextUnet

    model = JaxContextUnet(in_channels=1, n_feat=8, n_cfeat=3, height=H, levels=2)
    variables = jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(0), np.zeros((1, H, H, 1), np.float32),
        np.array([0.5], np.float32)))
    return model, variables


def _tiny_port(variables=None):
    from camels_diffusion_model_tpu_torch.models.context_unet import ContextUnet

    model = ContextUnet(n_feat=8, n_cfeat=3, height=H)
    if variables is not None:
        model.load_state_dict(from_jax_variables(variables))
    return model


def _batches(n):
    rs = np.random.RandomState(2)
    return [(rs.rand(4, H, H, 1).astype(np.float32), rs.rand(4, 3).astype(np.float32))
            for _ in range(n)]


def _state_dicts_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


def test_weights_files_are_the_jax_packages_byte_for_byte(tiny_jax, tmp_path):
    """One model's weights file from either package is the same bytes, and
    each package loads the other's."""
    from camels_diffusion_model_tpu.training import checkpoints as jax_ckpt
    from camels_diffusion_model_tpu_torch.training import checkpoints

    _, variables = tiny_jax
    import jax

    variables = {"params": variables["params"], "batch_stats": jax.tree_util.tree_map(
        lambda a: a + 0.25, variables["batch_stats"])}  # running statistics that moved
    jax_path, port_path = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    jax_ckpt.save_model_weights(variables, jax_path)
    port = _tiny_port(variables)
    checkpoints.save_model_weights(port, port_path)
    with open(jax_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()
    restored = jax_ckpt.load_model_weights(variables, port_path)
    for col in ("params", "batch_stats"):
        for name, want in _leaves(variables[col]):
            np.testing.assert_array_equal(dict(_leaves(restored[col]))[name], want)
    loaded = checkpoints.load_model_weights(_tiny_port(), jax_path)
    _state_dicts_equal(loaded.state_dict(), port.state_dict())


def test_train_checkpoints_cross_the_two_packages(tiny_jax, tmp_path):
    """A JAX train checkpoint after two steps loads into the port (params,
    batch_stats, Adam moments and count, step, epoch, rng) and the port
    writes it back byte for byte; a port checkpoint loads into JAX's
    ``load_train_checkpoint``."""
    import jax

    from camels_diffusion_model_tpu.training import (
        create_train_state as jax_create_train_state,
        load_train_checkpoint as jax_load_train_checkpoint,
        make_train_step as jax_make_train_step,
        save_train_checkpoint as jax_save_train_checkpoint,
    )
    from camels_diffusion_model_tpu_torch.training import checkpoints, trainer

    model, variables = tiny_jax
    jstate = jax_create_train_state(model, variables, 1e-3, 4, 2)
    jstep = jax_make_train_step(model, T)
    key = jax.random.PRNGKey(3)
    for x, c in _batches(2):
        key, k = jax.random.split(key)
        jstate, _ = jstep(jstate, x, c, k)
    jax_path = str(tmp_path / "jax_state.msgpack")
    jax_save_train_checkpoint(jstate, 1, key, jax_path)

    port = _tiny_port()
    state = trainer.create_train_state(port, 1e-3, 4, 2)
    state, epoch, rng = checkpoints.load_train_checkpoint(state, jax_path)
    assert (epoch, state.step) == (1, 2)
    np.testing.assert_array_equal(rng, np.asarray(key))
    _state_dicts_equal(port.state_dict(), from_jax_variables(
        {"params": jax.device_get(jstate.params),
         "batch_stats": jax.device_get(jstate.batch_stats)}))
    adam = jax.device_get(jstate.opt_state[0])
    for key_name, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        want = from_jax_variables({"params": tree})
        for name, p in port.named_parameters():
            torch.testing.assert_close(state.optimizer.state[p][key_name], want[name],
                                       rtol=0, atol=0)
            assert float(state.optimizer.state[p]["step"]) == 2.0
    port_path = str(tmp_path / "port_state.msgpack")
    checkpoints.save_train_checkpoint(state, 1, port_path)
    with open(jax_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()

    port2 = _tiny_port(variables)
    state2 = trainer.create_train_state(port2, 1e-3, 4, 2, seed=9)
    step = trainer.make_train_step(port2, T)
    for x, c in _batches(3):
        step(state2, x, c)
    checkpoints.save_train_checkpoint(state2, 2, port_path)
    template = jax_create_train_state(model, variables, 1e-3, 4, 2)
    restored, epoch, rng = jax_load_train_checkpoint(template, port_path)
    assert (epoch, int(restored.step)) == (2, 3)
    np.testing.assert_array_equal(np.asarray(rng), [0, 9])
    assert int(restored.opt_state[0].count) == int(restored.opt_state[1].count) == 3
    want = to_jax_variables(port2.state_dict())
    for col, tree in (("params", restored.params), ("batch_stats", restored.batch_stats)):
        for name, a in _leaves(want[col]):
            np.testing.assert_array_equal(dict(_leaves(jax.device_get(tree)))[name], a)
    moments = {n: state2.optimizer.state[p]["exp_avg_sq"] for n, p in port2.named_parameters()}
    for name, a in _leaves(to_jax_variables(moments)["params"]):
        np.testing.assert_array_equal(
            dict(_leaves(jax.device_get(restored.opt_state[0].nu)))[name], a)


def test_port_resume_is_bitwise(tiny_jax, tmp_path):
    """Four steps equal two steps, a save, a load into a fresh model and
    optimizer, and two more steps, bit for bit on the CPU: each step draws
    from ``(seed, 0, step)``."""
    from camels_diffusion_model_tpu_torch.training import checkpoints, trainer

    _, variables = tiny_jax
    batches = _batches(4)

    def fresh():
        port = _tiny_port(variables)
        return port, trainer.create_train_state(port, 1e-3, 2, 2, seed=17)

    port_a, state_a = fresh()
    step_a = trainer.make_train_step(port_a, T)
    for x, c in batches:
        step_a(state_a, x, c)

    port_b, state_b = fresh()
    step_b = trainer.make_train_step(port_b, T)
    for x, c in batches[:2]:
        step_b(state_b, x, c)
    path = str(tmp_path / "train_state.msgpack")
    checkpoints.save_train_checkpoint(state_b, 1, path)
    port_c, state_c = fresh()
    state_c.seed = 0  # the checkpoint's rng restores it
    state_c, epoch, _ = checkpoints.load_train_checkpoint(state_c, path)
    assert (epoch, state_c.step, state_c.seed) == (1, 2, 17)
    step_c = trainer.make_train_step(port_c, T)
    for x, c in batches[2:]:
        step_c(state_c, x, c)
    _state_dicts_equal(port_c.state_dict(), port_a.state_dict())
    for (pa, pc) in zip(port_a.parameters(), port_c.parameters()):
        for key_name in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(state_c.optimizer.state[pc][key_name],
                                       state_a.optimizer.state[pa][key_name], rtol=0, atol=0)
