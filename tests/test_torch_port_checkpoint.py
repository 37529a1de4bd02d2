"""PyTorch port: the in-package msgpack decoder, the checkpoint loader and
the weight conversion, against flax on the committed checkpoint."""

import os

import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from camels_diffusion_model_tpu.serving import _md5
from camels_diffusion_model_tpu_torch import _msgpack
from camels_diffusion_model_tpu_torch.training.checkpoints import load_variables, md5
from camels_diffusion_model_tpu_torch.utils.weights import from_jax_variables

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


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63, -1, -32, -33, -128,
    -129, -2**15 - 1, -2**31 - 1, -2**63, 1.5, -2.25e300, None, True, False,
    "", "x" * 31, "y" * 32, "z" * 300, "w" * 70000, [], list(range(15)),
    list(range(16)), list(range(70000)), {}, {str(i): i for i in range(16)},
    {"nested": {"a": [1, {"b": "c"}]}},
])
def test_msgpack_decodes_msgpack_package_output(value):
    assert _msgpack.unpackb(msgpack.packb(value, use_bin_type=True)) == value


@pytest.mark.parametrize("payload", [b"", b"\x00" * 5, b"\x01" * 300, b"\x02" * 70000])
def test_msgpack_bin_is_zero_copy_view(payload):
    data = msgpack.packb(payload, use_bin_type=True)
    got = _msgpack.unpackb(data)
    assert isinstance(got, memoryview) and bytes(got) == payload


@pytest.mark.parametrize("arr", [
    np.arange(12, dtype=np.float32).reshape(3, 4),
    np.zeros((0, 2), np.float64),
    np.array([[1, -2]], np.int32),
    np.ones((2, 2, 2), np.uint8),
])
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
