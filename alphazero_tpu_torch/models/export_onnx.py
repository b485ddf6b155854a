"""ONNX export (counterpart of ``alphazero_tpu/models/export_onnx.py``, a
copy of its writer, reader and executor).

Neither machine has the ``onnx`` package or an ONNX runtime (and
``torch.onnx.export`` needs ``onnx``), so this module is self-contained:

  * a minimal protobuf wire-format writer emitting a standard ONNX
    ``ModelProto`` (ir_version 8, opset 13) for the BN-folded AZResNet,
    fed by ``models/quant.extract_folded``: Conv/Relu/Add/Mul/Sigmoid/Tanh/
    GlobalAveragePool/Reshape/Transpose/Gemm nodes, NCHW input, a dynamic
    batch dimension; the nodes, their names and the initialisers' layouts
    are the JAX package's;
  * a minimal ONNX reader and numpy executor (``load_and_run_onnx``) used
    for output parity: the exported file is parsed back from its bytes and
    replayed with numpy, so verification exercises the serialized artifact
    itself.

Forward contract: NCHW observation planes -> (policy_logits [B, A],
value [B]).
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

# --------------------------------------------------------------------------
# protobuf wire-format primitives (proto3 subset used by onnx.proto)

_F_FLOAT = 1  # TensorProto.DataType
_F_INT64 = 7


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _int(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _bytes(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _string(field: int, s: str) -> bytes:
    return _bytes(field, s.encode())


def _packed_ints(field: int, values) -> bytes:
    return _bytes(field, b"".join(_varint(v) for v in values))


# --------------------------------------------------------------------------
# ONNX message builders

def _tensor(name: str, arr: np.ndarray) -> bytes:
    """TensorProto with raw_data."""
    if arr.dtype == np.int64:
        dt = _F_INT64
    else:
        arr = arr.astype(np.float32)
        dt = _F_FLOAT
    out = b"".join(_int(1, d) for d in arr.shape)
    out += _int(2, dt)
    out += _string(8, name)
    out += _bytes(9, arr.tobytes())  # raw_data, little-endian
    return out


_ATTR_FLOAT, _ATTR_INT, _ATTR_INTS = 1, 2, 7


def _attr_int(name: str, v: int) -> bytes:
    return _string(1, name) + _int(3, v) + _int(20, _ATTR_INT)


def _attr_float(name: str, v: float) -> bytes:
    return (_string(1, name) + _tag(2, 5) + struct.pack("<f", v)
            + _int(20, _ATTR_FLOAT))


def _attr_ints(name: str, vals) -> bytes:
    return _string(1, name) + _packed_ints(8, vals) + _int(20, _ATTR_INTS)


def _node(op: str, inputs, outputs, attrs: bytes = b"", name: str = "") -> bytes:
    out = b"".join(_string(1, i) for i in inputs)
    out += b"".join(_string(2, o) for o in outputs)
    out += _string(3, name or outputs[0])
    out += _string(4, op)
    if attrs:
        out += attrs
    return out


def _value_info(name: str, dims) -> bytes:
    """ValueInfoProto; dims entries: int (dim_value) or str (dim_param)."""
    shape = b""
    for d in dims:
        dim = _string(3, d) if isinstance(d, str) else _int(1, d)
        shape += _bytes(1, dim)
    tensor_type = _int(1, _F_FLOAT) + _bytes(2, shape)
    type_proto = _bytes(1, tensor_type)
    return _string(1, name) + _bytes(2, type_proto)


# --------------------------------------------------------------------------
# graph construction for the folded AZResNet

def _build_graph(fp: Dict[str, Any], obs_shape, num_actions: int) -> bytes:
    C, H, W = obs_shape
    nodes: List[bytes] = []
    inits: List[bytes] = []

    def init_arr(name, arr):
        inits.append(_tensor(name, np.asarray(arr)))
        return name

    def conv_w(name, w):
        # flax HWIO -> ONNX OIHW
        k = np.transpose(np.asarray(w["kernel"], np.float32), (3, 2, 0, 1))
        return (init_arr(name + "_w", k),
                init_arr(name + "_b", np.asarray(w["bias"], np.float32)))

    def dense_w(name, w):
        # [in, out] kept as-is; Gemm transB=0 computes X @ W + b.
        return (init_arr(name + "_w", np.asarray(w["kernel"], np.float32)),
                init_arr(name + "_b", np.asarray(w["bias"], np.float32)))

    def conv(x, w_name, out, ksize):
        wn, bn = w_name
        pad = ksize // 2
        attrs = (_bytes(5, _attr_ints("kernel_shape", [ksize, ksize]))
                 + _bytes(5, _attr_ints("pads", [pad] * 4))
                 + _bytes(5, _attr_ints("strides", [1, 1])))
        nodes.append(_node("Conv", [x, wn, bn], [out], attrs))
        return out

    def relu(x, out):
        nodes.append(_node("Relu", [x], [out]))
        return out

    def gemm(x, w_name, out, act=None):
        wn, bn = w_name
        attrs = (_bytes(5, _attr_float("alpha", 1.0))
                 + _bytes(5, _attr_float("beta", 1.0))
                 + _bytes(5, _attr_int("transB", 0)))
        nodes.append(_node("Gemm", [x, wn, bn], [out], attrs))
        return out

    flat_shape = init_arr("shape_flat", np.asarray([0, -1], np.int64))

    # stem
    a = relu(conv("obs", conv_w("stem", fp["stem"]), "stem_y", 3),
             "a0")
    # residual tower
    for i, blk in enumerate(fp["blocks"]):
        p = f"b{i}_"
        h = relu(conv(a, conv_w(p + "c1", blk["conv1"]), p + "h_pre", 3),
                 p + "h")
        h2 = conv(h, conv_w(p + "c2", blk["conv2"]), p + "h2", 3)
        nodes.append(_node("GlobalAveragePool", [h2], [p + "gap"]))
        nodes.append(_node("Reshape", [p + "gap", flat_shape], [p + "s"]))
        s1 = relu(gemm(p + "s", dense_w(p + "se1", blk["se1"]), p + "s1"),
                  p + "s1r")
        g = gemm(s1, dense_w(p + "se2", blk["se2"]), p + "s2")
        nodes.append(_node("Sigmoid", [g], [p + "g"]))
        ch = blk["conv2"]["bias"].shape[0]
        g_shape = init_arr(p + "gshape",
                           np.asarray([0, int(ch), 1, 1], np.int64))
        nodes.append(_node("Reshape", [p + "g", g_shape], [p + "g4"]))
        nodes.append(_node("Mul", [h2, p + "g4"], [p + "gated"]))
        nodes.append(_node("Add", [a, p + "gated"], [p + "sum"]))
        a = relu(p + "sum", f"a{i + 1}")

    perm_nhwc = _bytes(5, _attr_ints("perm", [0, 2, 3, 1]))

    # policy head — flax flattens NHWC, so transpose before Reshape.
    pc = relu(conv(a, conv_w("pconv", fp["policy_conv"]), "p_pre", 1), "p")
    nodes.append(_node("Transpose", [pc], ["p_nhwc"], perm_nhwc))
    nodes.append(_node("Reshape", ["p_nhwc", flat_shape], ["p_flat"]))
    gemm("p_flat", dense_w("pfc", fp["policy_dense"]), "policy_logits")

    # value head
    vc = relu(conv(a, conv_w("vconv", fp["value_conv"]), "v_pre", 1), "v")
    nodes.append(_node("Transpose", [vc], ["v_nhwc"], perm_nhwc))
    nodes.append(_node("Reshape", ["v_nhwc", flat_shape], ["v_flat"]))
    v1 = relu(gemm("v_flat", dense_w("vfc1", fp["value_dense1"]), "v1"),
              "v1r")
    v2 = gemm(v1, dense_w("vfc2", fp["value_dense2"]), "v2")
    nodes.append(_node("Tanh", [v2], ["v_tanh"]))
    sq_shape = init_arr("shape_squeeze", np.asarray([-1], np.int64))
    nodes.append(_node("Reshape", ["v_tanh", sq_shape], ["value"]))

    graph = b"".join(_bytes(1, n) for n in nodes)
    graph += _string(2, "alphazero_tpu")
    graph += b"".join(_bytes(5, t) for t in inits)
    graph += _bytes(11, _value_info("obs", ["batch", C, H, W]))
    graph += _bytes(12, _value_info("policy_logits",
                                    ["batch", num_actions]))
    graph += _bytes(12, _value_info("value", ["batch"]))
    return graph


def _numpy_tree(x):
    if isinstance(x, dict):
        return {k: _numpy_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_numpy_tree(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return x


def export_onnx(model, obs_shape: Tuple[int, int, int], out_path: str) -> str:
    """BN-fold ``model`` (``models/quant.extract_folded``) and write a
    standard ONNX file (opset 13)."""
    from alphazero_tpu_torch.models.quant import extract_folded

    fp = _numpy_tree(extract_folded(model))
    graph = _build_graph(fp, obs_shape, model.num_actions)
    opset = _string(1, "") + _int(2, 13)
    proto = (_int(1, 8)  # ir_version
             + _string(2, "alphazero_tpu")
             + _string(3, "1.0")
             + _bytes(7, graph)
             + _bytes(8, opset))
    with open(out_path, "wb") as f:
        f.write(proto)
    return out_path


# --------------------------------------------------------------------------
# minimal ONNX reader + numpy executor (for parity verification)

def _parse_msg(buf: bytes) -> List[Tuple[int, int, Any]]:
    """Flat (field, wire, value) list for one message."""
    out = []
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wire == 5:
            v = struct.unpack("<f", buf[i:i + 4])[0]
            i += 4
        elif wire == 1:
            v = struct.unpack("<d", buf[i:i + 8])[0]
            i += 8
        else:  # pragma: no cover
            raise ValueError(f"unsupported wire type {wire}")
        out.append((field, wire, v))
    return out


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _fields(msg, field):
    return [v for f, _, v in msg if f == field]


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    msg = _parse_msg(buf)
    dims = _fields(msg, 1)
    dtype = (_fields(msg, 2) or [_F_FLOAT])[0]
    name = _fields(msg, 8)[0].decode()
    raw = _fields(msg, 9)[0]
    np_dt = np.int64 if dtype == _F_INT64 else np.float32
    return name, np.frombuffer(raw, np_dt).reshape(dims)


def _parse_attrs(attr_bufs) -> Dict[str, Any]:
    out = {}
    for buf in attr_bufs:
        msg = _parse_msg(buf)
        name = _fields(msg, 1)[0].decode()
        atype = (_fields(msg, 20) or [0])[0]
        if atype == _ATTR_INT:
            out[name] = _fields(msg, 3)[0]
        elif atype == _ATTR_FLOAT:
            out[name] = _fields(msg, 2)[0]
        elif atype == _ATTR_INTS:
            packed = _fields(msg, 8)
            vals = []
            for p in packed:
                if isinstance(p, (bytes, bytearray)):
                    i = 0
                    while i < len(p):
                        v, i = _read_varint(p, i)
                        vals.append(v)
                else:
                    vals.append(p)
            out[name] = vals
    return out


def _np_conv(x, w, b, pads, strides):
    B, C, H, Wd = x.shape
    O, I, kh, kw = w.shape
    xp = np.pad(x, ((0, 0), (0, 0), (pads[0], pads[2]), (pads[1], pads[3])))
    oh = (xp.shape[2] - kh) // strides[0] + 1
    ow = (xp.shape[3] - kw) // strides[1] + 1
    cols = np.empty((B, C, kh, kw, oh, ow), x.dtype)
    for i in range(kh):
        for j in range(kw):
            cols[:, :, i, j] = xp[
                :, :, i:i + oh * strides[0]:strides[0],
                j:j + ow * strides[1]:strides[1]]
    y = np.einsum("bcijhw,ocij->bohw", cols, w, optimize=True)
    return (y + b[None, :, None, None]).astype(np.float32)


def _np_reshape(x, shape):
    shape = [int(s) for s in shape]
    out = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return x.reshape(out)


def load_and_run_onnx(path: str, obs: np.ndarray):
    """Parse an exported file and execute it with numpy.
    Returns (policy_logits, value)."""
    with open(path, "rb") as f:
        model_msg = _parse_msg(f.read())
    graph = _parse_msg(_fields(model_msg, 7)[0])
    values: Dict[str, np.ndarray] = {}
    for t in _fields(graph, 5):
        name, arr = _parse_tensor(t)
        values[name] = arr
    values["obs"] = np.asarray(obs, np.float32)

    for node_buf in _fields(graph, 1):
        msg = _parse_msg(node_buf)
        inputs = [v.decode() for f, _, v in msg if f == 1]
        outputs = [v.decode() for f, _, v in msg if f == 2]
        op = _fields(msg, 4)[0].decode()
        attrs = _parse_attrs(_fields(msg, 5))
        ins = [values[i] for i in inputs]
        if op == "Conv":
            y = _np_conv(ins[0], ins[1], ins[2],
                         attrs.get("pads", [0, 0, 0, 0]),
                         attrs.get("strides", [1, 1]))
        elif op == "Relu":
            y = np.maximum(ins[0], 0)
        elif op == "Add":
            y = ins[0] + ins[1]
        elif op == "Mul":
            y = ins[0] * ins[1]
        elif op == "Sigmoid":
            y = 1.0 / (1.0 + np.exp(-ins[0]))
        elif op == "Tanh":
            y = np.tanh(ins[0])
        elif op == "GlobalAveragePool":
            y = ins[0].mean(axis=(2, 3), keepdims=True)
        elif op == "Reshape":
            y = _np_reshape(ins[0], ins[1])
        elif op == "Transpose":
            y = np.transpose(ins[0], attrs["perm"])
        elif op == "Gemm":
            a, w, c = ins
            if attrs.get("transB", 0):
                w = w.T
            y = attrs.get("alpha", 1.0) * (a @ w) + attrs.get("beta",
                                                              1.0) * c
        else:  # pragma: no cover
            raise ValueError(f"unsupported op {op}")
        values[outputs[0]] = np.asarray(y, np.float32)
    return values["policy_logits"], values["value"]


def verify_onnx_export(model, obs: Any, onnx_path: str,
                       atol: float = 2e-2) -> dict:
    """Round-trip parity: parse the exported bytes, replay them with numpy,
    and compare with the port's folded eval in float32
    (``make_inference_eval_fn``, on ``model``'s device, TF32 off) on
    ``obs``."""
    from alphazero_tpu_torch.models.export_torch import full_f32
    from alphazero_tpu_torch.models.resnet import make_inference_eval_fn

    obs = np.asarray(obs, np.float32)
    device = next(model.parameters()).device
    with full_f32():
        ml, mv = make_inference_eval_fn(model, torch.float32)(
            torch.from_numpy(obs).to(device))
    ol, ov = load_and_run_onnx(onnx_path, obs)
    dl = float(np.max(np.abs(ml.cpu().numpy() - ol)))
    dv = float(np.max(np.abs(mv.cpu().numpy() - ov)))
    if dl > atol or dv > atol:
        raise AssertionError(
            f"ONNX export diverges: logits {dl:.4f}, value {dv:.4f}"
        )
    return {"max_logit_dev": dl, "max_value_dev": dv}
