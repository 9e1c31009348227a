"""The JAX package's checkpoint files, read and written by the port.

`ldt_tpu/training/checkpoint.py` saves {cfg, state, epoch, itr, time} as
`checkpt_{epoch}.msgpack`, in one of two formats:

  * one msgpack file, flax's `msgpack_serialize` of the whole dict;
  * for states of 256 MiB and more, a msgpack manifest (format
    "ldt-sharded-v1": each large leaf's path, dtype, shape, shard, offset
    and byte count, the small leaves inline) and the leaves' raw bytes in
    `checkpt_{epoch}.msgpack.shard{K}` files.

The port reads both (`load_jax_checkpoint`) into its own names and writes
both (`save_jax_checkpoint`), with its own msgpack codec: the subset of the
public msgpack format that flax writes (maps, arrays, str, bin, ints,
floats, bool, nil, and the ext types 1, an array as a packed (shape, dtype
name, bytes), and 3, a numpy scalar as a 0-d array), so that neither the
card nor the port needs the `msgpack` package. `packb` gives the bytes
`flax.serialization.msgpack_serialize` gives for the same tree, including
its `__msgpack_chunked_array__` split of arrays over 2**30 bytes. Arrays
decode as tensors, bfloat16 by its name.

The trees map through `ldt_torch.weights`: the params, the EMA and the Adam
moments as params (the map is linear), `batch_stats` as the BatchNorms'
running statistics (the stage-1 Compressor's, and a conditional Score's
ConditionNet's); writing one, the config's `norm` names the JAX
norms. optax's chain state is {"0": ..., "1": ...}: the Adam entry (count,
mu, nu) is found by its keys; every other entry must be
empty (the clip's and the weight decay's) and is written back empty, which
a strict JAX restore needs. Moments saved in bf16 are cast to f32, the
step is a 0-d int32 array. A leaf that maps to nothing raises, either way.
"""

from __future__ import annotations

import os
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ldt_torch.tools.io import namespace2dict
from ldt_torch.training.checkpoint import write_atomic
from ldt_torch.weights import (
    compressor_state_dict,
    compressor_variables,
    score_state_dict,
    score_variables,
)

SHARD_FORMAT = "ldt-sharded-v1"
DEFAULT_SHARD_THRESHOLD = 256 * 1024 * 1024  # single file below this
_SHARD_TARGET_BYTES = 512 * 1024 * 1024       # per shard
_MAX_SHARDS = 16
_BIG_LEAF_BYTES = 1 << 20                     # leaves from here go to shards
_MAX_CHUNK_SIZE = 2 ** 30  # flax splits arrays above this many bytes
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3

_TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


# ---------------------------------------------------------------- msgpack

def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        if x.dtype not in _DTYPE_NAMES:
            raise TypeError(f"no msgpack encoding for a {x.dtype} tensor")
        return _DTYPE_NAMES[x.dtype]
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise TypeError("object and structured arrays are not encoded")
    return x.dtype.name


def _array_parts(x) -> Tuple[List[int], str, bytes]:
    """(shape, dtype name, C-order bytes) of a numpy array or a tensor."""
    name = _dtype_name(x)
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return list(t.shape), name, raw.numpy().tobytes()
    return list(x.shape), name, x.tobytes("C")


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunk(x) -> dict:
    """flax's `_chunk`: a flat array split into pieces of < 2**30 bytes."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) \
        else x.dtype.itemsize
    size = max(1, int(_MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.numel() if isinstance(x, torch.Tensor) else flat.size
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _sorted(tree):
    """A copy with every dict's keys sorted, as the `tree_map` copy in
    flax's `msgpack_serialize` sorts them."""
    if isinstance(tree, dict):
        return {k: _sorted(v) for k, v in sorted(tree.items())}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted(v) for v in tree)
    return tree


def _chunk_leaves(tree):
    """flax's `_chunk_array_leaves_in_place`, on a copy: arrays of the root
    and of dict values split by `_chunk` where they are too large."""
    if isinstance(tree, dict):
        return {k: (_chunk(v) if _is_array(v) and _nbytes(v) > _MAX_CHUNK_SIZE
                    else _chunk_leaves(v) if isinstance(v, dict) else v)
                for k, v in tree.items()}
    if _is_array(tree) and _nbytes(tree) > _MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _pack_len(out: bytearray, n: int, small: Tuple[int, int],
              codes: Tuple[int, int, int]) -> None:
    """A length header: `small` = (fix base, fix limit), else 8/16/32-bit
    `codes` (a None code skips that width)."""
    base, limit = small
    if limit and n < limit:
        out.append(base | n)
    elif codes[0] is not None and n < 1 << 8:
        out += bytes((codes[0], n))
    elif n < 1 << 16:
        out.append(codes[1])
        out += struct.pack(">H", n)
    elif n < 1 << 32:
        out.append(codes[2])
        out += struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack object of {n} entries or bytes")


def _pack_int(out: bytearray, v: int) -> None:
    if -32 <= v < 128:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v >= 0:
        for fmt, code in ((">B", 0xcc), (">H", 0xcd), (">I", 0xce),
                          (">Q", 0xcf)):
            if v < 1 << (8 * struct.calcsize(fmt)):
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack")
    else:
        for fmt, code in ((">b", 0xd0), (">h", 0xd1), (">i", 0xd2),
                          (">q", 0xd3)):
            if v >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(out, n, (0, 0), (0xc7, 0xc8, 0xc9))
    out += struct.pack(">b", code)
    out += data


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xc0)
    elif obj is True or obj is False:
        out.append(0xc3 if obj else 0xc2)
    elif type(obj) is int:
        _pack_int(out, obj)
    elif type(obj) is float:
        out.append(0xcb)
        out += struct.pack(">d", obj)
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _pack_len(out, len(data), (0xa0, 32), (0xd9, 0xda, 0xdb))
        out += data
    elif type(obj) in (bytes, bytearray):
        _pack_len(out, len(obj), (0, 0), (0xc4, 0xc5, 0xc6))
        out += obj
    elif type(obj) is dict:
        _pack_len(out, len(obj), (0x80, 16), (None, 0xde, 0xdf))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif type(obj) in (list, tuple):
        _pack_len(out, len(obj), (0x90, 16), (None, 0xdc, 0xdd))
        for v in obj:
            _pack(v, out)
    elif _is_array(obj):
        _pack_ext(out, _EXT_NDARRAY, packb(list(_array_parts(obj))))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, packb(list(_array_parts(
            np.asarray(obj)))))
    else:
        raise TypeError(f"no msgpack encoding for {type(obj).__name__}")


def packb(tree) -> bytes:
    """msgpack bytes of `tree` as flax's `msgpack_serialize` writes them
    (arrays over 2**30 bytes split into chunks)."""
    out = bytearray()
    _pack(_chunk_leaves(_sorted(tree)), out)
    return bytes(out)


def _tensor(shape, dtype_name, data) -> torch.Tensor:
    name = dtype_name.decode() if isinstance(dtype_name, bytes) \
        else dtype_name
    if name not in _TORCH_DTYPES:
        raise ValueError(f"checkpoint array of dtype {name}: not supported")
    dtype = _TORCH_DTYPES[name]
    if len(data) == 0:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(data), dtype=dtype).reshape(shape)


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        lens = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B",
                0xda: ">H", 0xdb: ">I"}
        if b in lens:
            data = self.take(self.unpack(lens[b]))
            return bytes(data) if b <= 0xc6 else str(data, "utf-8")
        if b in (0xc7, 0xc8, 0xc9):
            n = self.unpack({0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}[b])
            return self.ext(n)
        if 0xd4 <= b <= 0xd8:
            return self.ext(1 << (b - 0xd4))
        nums = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
                0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if b in nums:
            return self.unpack(nums[b])
        if b in (0xdc, 0xdd):
            n = self.unpack(">H" if b == 0xdc else ">I")
            return [self.value() for _ in range(n)]
        if b in (0xde, 0xdf):
            return self.map(self.unpack(">H" if b == 0xde else ">I"))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, name, raw = _Reader(data).value()
            return _tensor(shape, name, raw)
        raise ValueError(f"msgpack ext type {code} is not supported")


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            chunks = tree["chunks"]
            flat = torch.cat([chunks[str(i)] for i in range(len(chunks))])
            shape = tree["shape"]
            return flat.reshape([shape[str(i)] for i in range(len(shape))])
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data) -> Any:
    """The tree of msgpack bytes written by flax (arrays as tensors, the
    chunked ones joined)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(out)


# ------------------------------------------------------------- the files

def _flatten(tree, prefix=()):
    """(path, leaf) pairs; empty dicts and None are leaves."""
    if isinstance(tree, dict) and tree:
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    else:
        yield prefix, tree


def _insert(tree: dict, path, leaf) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = leaf


def read_jax_file(path: str) -> Dict[str, Any]:
    """{cfg, state, epoch, itr, time} of a JAX checkpoint, either format,
    with the JAX package's names and dtypes."""
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    if not (isinstance(payload, dict) and payload.get("format") ==
            SHARD_FORMAT):
        return payload

    def read(i):
        with open(f"{path}.shard{i}", "rb") as f:
            return i, bytearray(f.read())

    n = int(payload["nshards"])
    with ThreadPoolExecutor(max_workers=min(8, max(n, 1))) as pool:
        shards = dict(pool.map(read, range(n)))
    state = payload.get("state", {})
    for leaf in payload["leaves"]:
        dtype = _TORCH_DTYPES[leaf["dtype"]]
        nbytes, offset = int(leaf["nbytes"]), int(leaf["offset"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        t = torch.frombuffer(shards[int(leaf["shard"])], dtype=dtype,
                             count=nbytes // itemsize, offset=offset) \
            if nbytes else torch.empty((0,), dtype=dtype)
        _insert(state, tuple(leaf["path"]), t.reshape(leaf["shape"]))
    return {"cfg": payload.get("cfg", {}), "state": state,
            "epoch": payload["epoch"], "itr": payload["itr"],
            "time": payload["time"]}


def _write_sharded(path: str, state, meta: Dict[str, Any]) -> None:
    """The JAX package's sharded format (`_save_sharded`)."""
    big, small = [], []
    for p, v in _flatten(state):
        if _is_array(v) and _nbytes(v) >= _BIG_LEAF_BYTES:
            big.append((p, v))
        else:
            small.append((p, v))
    total = sum(_nbytes(v) for _, v in big)
    nshards = max(1, min(_MAX_SHARDS, -(-total // _SHARD_TARGET_BYTES)))
    shard_bytes = [0] * nshards
    shard_items: list = [[] for _ in range(nshards)]
    for p, v in sorted(big, key=lambda kv: -_nbytes(kv[1])):
        i = min(range(nshards), key=lambda j: shard_bytes[j])
        shard_items[i].append((p, v))
        shard_bytes[i] += _nbytes(v)
    leaves = []
    for i, chunk in enumerate(shard_items):
        offset = 0
        for p, v in chunk:
            leaves.append({"path": list(p), "dtype": _dtype_name(v),
                           "shape": list(v.shape), "shard": i,
                           "offset": offset, "nbytes": _nbytes(v)})
            offset += _nbytes(v)

    def write_shard(i):
        def write(tmp):
            with open(tmp, "wb") as f:
                for _, v in shard_items[i]:
                    f.write(_array_parts(v)[2])
        write_atomic(f"{path}.shard{i}", write)

    with ThreadPoolExecutor(max_workers=min(8, nshards)) as pool:
        list(pool.map(write_shard, range(nshards)))
    root: dict = {}
    for p, v in small:
        if p:
            _insert(root, p, v)
    manifest = dict(meta)
    manifest.update({"format": SHARD_FORMAT, "nshards": nshards,
                     "leaves": leaves, "state": root})
    _write_bytes(path, packb(manifest))
    for j in range(nshards, _MAX_SHARDS):  # shards of an earlier save
        stale = f"{path}.shard{j}"
        if os.path.exists(stale):
            os.remove(stale)


def _write_bytes(path: str, data: bytes) -> None:
    def write(tmp):
        with open(tmp, "wb") as f:
            f.write(data)
    write_atomic(path, write)


# --------------------------------------------------------------- mapping

def _f32(tree):
    """Floating tensors as f32 (bf16 moments back to f32); numpy for the
    converters."""
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy() if tree.is_floating_point() else tree
    return tree


def _adam_entry(opt_state: dict) -> dict:
    """The (count, mu, nu) entry of an optax chain state; every other entry
    must be empty."""
    adam = [v for v in opt_state.values()
            if isinstance(v, dict) and set(v) == {"count", "mu", "nu"}]
    other = [k for k, v in opt_state.items()
             if v != {} and not any(v is a for a in adam)]
    if len(adam) != 1 or other:
        raise ValueError(f"optimizer state {sorted(opt_state)}: expected "
                         "one Adam entry (count, mu, nu) and empty entries, "
                         f"found {len(adam)} Adam entries and {other}")
    return adam[0]


def _state_from_jax(ts: dict, to_port) -> dict:
    """A JAX TrainState dict -> the port's `TrainState.to_tree()` layout;
    `to_port(params_tree)` maps a params-structured tree."""
    adam = _adam_entry(ts["opt_state"])
    ema = ts.get("ema_params")
    return {"step": int(ts["step"]), "params": to_port(ts["params"]),
            "ema_params": None if ema is None else to_port(ema),
            "opt_state": {"count": int(adam["count"]),
                          "mu": to_port(adam["mu"]),
                          "nu": to_port(adam["nu"])},
            "batch_stats": None}


def _stats_state_from_jax(ts: dict, to_sd) -> dict:
    """A JAX TrainState of a net with BatchNorms (`to_sd(params,
    batch_stats)` its state_dict converter) -> the port's layout: the
    params-structured trees without, `batch_stats` the running
    statistics."""
    stats = _f32(ts.get("batch_stats") or {})

    def to_port(tree):
        sd = to_sd(_f32(tree), stats)
        return {k: v for k, v in sd.items() if "running_" not in k}

    out = _state_from_jax(ts, to_port)
    if stats:
        sd = to_sd(_f32(ts["params"]), stats)
        out["batch_stats"] = {k: v for k, v in sd.items()
                              if "running_" in k}
    return out


def state_from_jax(state: dict) -> dict:
    """A JAX checkpoint's state -> the port's names: {"state": ...} (a
    stage-1 trainer) or {"score": ..., "compressor": ...} (stage 2); any
    other top-level entry is left as it is (a strict restore refuses
    it)."""
    out = dict(state)
    if "state" in state:
        out["state"] = _stats_state_from_jax(
            state["state"], lambda p, st: compressor_state_dict(
                {"params": p, "batch_stats": st}))
    if "score" in state:  # a conditional Score's c_net has BatchNorms
        out["score"] = _stats_state_from_jax(state["score"],
                                             score_state_dict)
    if "compressor" in state:
        out["compressor"] = compressor_state_dict(_f32(state["compressor"]))
    return out


def _jax_train_state(ts: dict, to_jax, tx, batch_stats=None) -> dict:
    """The port's TrainState tree -> the JAX TrainState dict, optax's chain
    laid out as `tx` (clip, weight decay, Adam) lays it."""
    adam = ts["opt_state"]
    chain = [{}] * (tx.grad_clip is not None) + [{}] * bool(tx.weight_decay)
    chain.append({"count": np.asarray(adam["count"], np.int32),
                  "mu": to_jax(adam["mu"]), "nu": to_jax(adam["nu"])})
    ema = ts["ema_params"]
    return {"step": np.asarray(ts["step"], np.int32),
            "params": to_jax(ts["params"]),
            "ema_params": None if ema is None else to_jax(ema),
            "opt_state": {str(i): s for i, s in enumerate(chain)},
            "batch_stats": batch_stats}


def _norm(cfg, section: str) -> str:
    """The config section's `norm` (what the JAX names of a state_dict's
    norms depend on), layer_norm without a config."""
    return getattr(getattr(cfg, section, None), "norm", None) or "layer_norm"


def state_to_jax(state: dict, tx, cfg=None) -> dict:
    """The port's state tree ({"state"} or {"score", "compressor"}) -> the
    JAX package's, for the optimizer `tx` of the trainer that saved it and
    its config `cfg` (the nets' `norm`)."""
    out = {}
    for key, value in state.items():
        if key == "state":
            norm = _norm(cfg, "model")
            stats = value["batch_stats"] or {}
            out[key] = _jax_train_state(
                value, lambda t: compressor_variables(t, norm)["params"], tx,
                compressor_variables({**value["params"], **stats},
                                     norm)["batch_stats"] or None)
        elif key == "score":
            norm = _norm(cfg, "score")
            stats = value.get("batch_stats") or {}
            out[key] = _jax_train_state(
                value, lambda t: score_variables(t, norm)["params"], tx,
                score_variables({**value["params"], **stats},
                                norm)["batch_stats"] or None)
        elif key == "compressor":
            out[key] = compressor_variables(value, _norm(cfg, "compressor"))
        else:
            raise ValueError(f"no JAX layout for the state entry {key!r}")
    return out


def load_jax_checkpoint(path: str) -> Dict[str, Any]:
    """{cfg, state, epoch, itr, time} of a JAX checkpoint, the state under
    the port's names (`state_from_jax`)."""
    ckpt = read_jax_file(path)
    return {"cfg": ckpt.get("cfg", {}), "state": state_from_jax(ckpt["state"]),
            "epoch": int(ckpt["epoch"]), "itr": int(ckpt["itr"]),
            "time": float(ckpt["time"])}


def save_jax_checkpoint(path: str, state: dict, tx, cfg=None,
                        epoch: int = 0, itr: int = 0, time: float = 0.0,
                        shard_threshold: int = DEFAULT_SHARD_THRESHOLD
                        ) -> None:
    """Write the port's state tree as the JAX package's checkpoint: one
    msgpack file below `shard_threshold` bytes, else the sharded format."""
    jax_state = state_to_jax(state, tx, cfg)
    meta = {"cfg": namespace2dict(cfg) if cfg is not None else {},
            "epoch": int(epoch), "itr": int(itr), "time": float(time)}
    total = sum(_nbytes(v) for _, v in _flatten(jax_state) if _is_array(v))
    if total >= shard_threshold:
        _write_sharded(path, jax_state, meta)
    else:
        _write_bytes(path, packb({**meta, "state": jax_state}))
