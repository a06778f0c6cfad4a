"""Output blob packing.

Pipeline outputs (a pytree of ~15-25 arrays) are concatenated on device
into ONE flat int32 blob -- the uint8 section padded and bitcast -- fetched
with a single transfer and re-split on host with numpy views, so each chunk
pays one device->host round trip instead of one per array.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def blobify(tree):
    """Inside jit: flatten a pytree of arrays into one int32 blob.

    Everything -- including the uint8 section, padded to 4 bytes and
    bitcast -- rides in a single array: one fetch per chunk.
    """
    leaves = jax.tree_util.tree_leaves(tree)
    i32_parts, i16_parts, u8_parts = [], [], []
    for x in leaves:
        if x.dtype == jnp.uint8:
            u8_parts.append(x.reshape(-1))
        elif x.dtype == jnp.bool_:
            u8_parts.append(x.astype(jnp.uint8).reshape(-1))
        elif x.dtype == jnp.int16:
            i16_parts.append(x.reshape(-1))
        elif x.dtype == jnp.uint32:
            i32_parts.append(jax.lax.bitcast_convert_type(x, jnp.int32).reshape(-1))
        else:
            i32_parts.append(x.astype(jnp.int32).reshape(-1))
    parts = list(i32_parts)
    if i16_parts:
        i16 = jnp.concatenate(i16_parts)
        if i16.shape[0] % 2:
            i16 = jnp.pad(i16, (0, 1))
        parts.append(jax.lax.bitcast_convert_type(i16.reshape(-1, 2), jnp.int32))
    if u8_parts:
        u8 = jnp.concatenate(u8_parts)
        pad = (-u8.shape[0]) % 4
        if pad:
            u8 = jnp.pad(u8, (0, pad))
        parts.append(jax.lax.bitcast_convert_type(u8.reshape(-1, 4), jnp.int32))
    if not parts:
        return jnp.zeros((0,), jnp.int32)
    return jnp.concatenate(parts)


def _build_spec(shaped_tree):
    """From a jax.eval_shape result: per-leaf (group, offset, shape, dtype),
    the i32-section length, and the treedef for reconstruction."""
    leaves, treedef = jax.tree_util.tree_flatten(shaped_tree)
    spec = []
    off_i32 = off_i16 = off_u8 = 0
    for x in leaves:
        size = int(np.prod(x.shape)) if x.shape else 1
        if x.dtype == jnp.uint8:
            spec.append(("u8", off_u8, x.shape, np.uint8))
            off_u8 += size
        elif x.dtype == jnp.bool_:
            spec.append(("u8", off_u8, x.shape, np.bool_))
            off_u8 += size
        elif x.dtype == jnp.int16:
            spec.append(("i16", off_i16, x.shape, np.int16))
            off_i16 += size
        elif x.dtype == jnp.uint32:
            spec.append(("i32", off_i32, x.shape, np.uint32))
            off_i32 += size
        else:
            spec.append(("i32", off_i32, x.shape, np.dtype(x.dtype.name)))
            off_i32 += size
    i16_words = (off_i16 + 1) // 2
    return treedef, spec, (off_i32, i16_words)


def unblobify(blob: np.ndarray, treedef, spec, section_lens):
    i32_len, i16_words = section_lens
    i32 = blob[:i32_len]
    i16 = blob[i32_len : i32_len + i16_words].view(np.int16)
    u8 = blob[i32_len + i16_words :].view(np.uint8)
    leaves = []
    for group, off, shape, dtype in spec:
        size = int(np.prod(shape)) if shape else 1
        if group == "u8":
            arr = u8[off : off + size]
            if dtype == np.bool_:
                arr = arr.astype(bool)
            arr = arr.reshape(shape)
        elif group == "i16":
            arr = i16[off : off + size].reshape(shape)
        else:
            arr = i32[off : off + size]
            if dtype == np.uint32:
                arr = arr.view(np.uint32)
            elif dtype == np.bool_:
                arr = arr.astype(bool)
            elif dtype != np.int32:
                arr = arr.astype(dtype)
            arr = arr.reshape(shape)
        leaves.append(arr)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _build_input_spec(rows: int, args, n_aux: int = 0) -> Tuple[Tuple, Tuple[int, int]]:
    """Input twin of :func:`_build_spec`: per-arg (group, offset, padded
    shape, dtype-name) entries plus section lengths, from the UNPADDED
    argument arrays (row dim padded to ``rows``; the trailing ``n_aux``
    args keep their own shape -- pack-level side data like dictionaries).

    Only the dtypes the pipelines take cross the wire: uint8 matrices
    (seq/qual/enc), int32 vectors (lens/starts), bool vectors (keep/real).
    """
    spec = []
    off_i32 = off_u8 = 0
    n_row = len(args) - n_aux
    for i, a in enumerate(args):
        shape = ((rows,) + tuple(a.shape[1:])) if i < n_row else tuple(a.shape)
        size = int(np.prod(shape))
        if a.dtype == np.uint8 or a.dtype == np.bool_:
            spec.append(("u8", off_u8, shape, a.dtype.name))
            off_u8 += size
        elif a.dtype == np.int32 or a.dtype == np.int64:
            spec.append(("i32", off_i32, shape, "int32"))
            off_i32 += size
        else:
            raise TypeError(f"unsupported input dtype {a.dtype}")
    return tuple(spec), (off_i32, (off_u8 + 3) // 4)


def pack_input_blob(args, spec, sections) -> np.ndarray:
    """Host side: write every (unpadded) argument into ONE int32 blob at its
    static offset; rows beyond each argument's length stay zero (exactly the
    zero-padding pad_rows produced, so bool masks pad to False).  One
    host->device transfer then carries the whole chunk."""
    i32_len, u8_words = sections
    blob = np.zeros(i32_len + u8_words, np.int32)
    u8 = blob[i32_len:].view(np.uint8)
    for a, (group, off, shape, dtype) in zip(args, spec):
        size = int(np.prod(shape))
        dst = (u8 if group == "u8" else blob)[off : off + size].reshape(shape)
        n = a.shape[0]
        if group == "u8":
            dst[:n] = a.view(np.uint8) if a.dtype == np.bool_ else a
        else:
            dst[:n] = a
    return blob


def unblob_inputs(blob: jnp.ndarray, spec, sections):
    """Device side (inside jit): re-split the input blob into the argument
    arrays with static slices; a bitcast recovers the uint8 section."""
    i32_len, u8_words = sections
    u8 = jax.lax.bitcast_convert_type(
        blob[i32_len:], jnp.uint8).reshape(-1)
    args = []
    for group, off, shape, dtype in spec:
        size = int(np.prod(shape))
        if group == "u8":
            x = u8[off : off + size].reshape(shape)
            if dtype == "bool":
                x = x != 0
        else:
            x = blob[off : off + size].reshape(shape)
        args.append(x)
    return args


class BlobResult:
    """Lazy handle over the in-flight device blob."""

    __slots__ = ("_blob", "_treedef", "_spec", "_sections")

    def __init__(self, blob, treedef, spec, sections):
        self._blob = blob
        self._treedef = treedef
        self._spec = spec
        self._sections = sections

    def get(self):
        return unblobify(np.asarray(self._blob), self._treedef, self._spec,
                         self._sections)


class BlobCall:
    """Callable wrapper: runs ``body`` under jit returning blobs, re-splits on
    host.  The output spec per (static kwargs, input shapes) signature is
    computed once with jax.eval_shape.  The call dispatches asynchronously and
    returns a :class:`BlobResult`.

    With a mesh installed via :meth:`set_mesh`, batch inputs (arrays whose
    leading dimension matches the chunk rows) are placed sharded over the
    read axis; jit then runs the pipeline data-parallel across the mesh,
    inserting cross-device reductions for the stat sums.
    """

    def __init__(self, body, static_argnames: Tuple[str, ...]):
        self._body = body
        self._jit = jax.jit(
            lambda *a, **kw: blobify(body(*a, **kw)),
            static_argnames=static_argnames)
        self._jit_in = jax.jit(
            lambda blob, in_spec, in_sections, **kw: blobify(
                body(*unblob_inputs(blob, in_spec, in_sections), **kw)),
            static_argnames=("in_spec", "in_sections") + tuple(static_argnames))
        self._specs: Dict[Any, Tuple] = {}
        self._in_specs: Dict[Any, Tuple] = {}
        self._mesh = None
        self._row_sharding = None

    def set_mesh(self, mesh) -> None:
        from jax.sharding import NamedSharding, PartitionSpec

        self._mesh = mesh
        if mesh is not None:
            axis = mesh.axis_names[0]
            self._row_sharding = NamedSharding(mesh, PartitionSpec(axis))

    def _place(self, args):
        if self._mesh is None:
            return args
        rows = max((a.shape[0] for a in args if getattr(a, "ndim", 0) >= 1),
                   default=0)
        out = []
        for a in args:
            if getattr(a, "ndim", 0) >= 1 and a.shape[0] == rows and \
                    rows % self._mesh.devices.size == 0:
                out.append(jax.device_put(a, self._row_sharding))
            else:
                out.append(a)
        return tuple(out)

    def call_blob(self, args, rows: int, aux=(), **static_kwargs) -> BlobResult:
        """Dispatch a chunk given UNPADDED arrays (row dim zero-padded to
        ``rows`` here, so runners never copy-pad).

        Default transport is per-array: dispatch is asynchronous, and the
        fused input blob adds a device-side bitcast/copy.
        FQTOOL_TPU_INBLOB=1 enables the one-message input blob for links
        where per-message latency dominates instead."""
        import os
        aux = tuple(aux)
        if self._mesh is not None or \
                os.environ.get("FQTOOL_TPU_INBLOB", "0") != "1":
            padded = []
            for a in args:
                if a.shape[0] != rows:
                    pad = [(0, rows - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
                    a = np.pad(a, pad)
                padded.append(a)
            return self(*padded, *aux, **static_kwargs)
        allargs = tuple(args) + aux
        key = (rows, tuple(sorted(static_kwargs.items())),
               tuple((tuple(a.shape), str(a.dtype)) for a in allargs))
        entry = self._in_specs.get(key)
        if entry is None:
            in_spec, in_sections = _build_input_spec(rows, allargs,
                                                     n_aux=len(aux))
            shaped_args = [jax.ShapeDtypeStruct(
                shape, np.int32 if dtype == "int64" else np.dtype(dtype))
                for _g, _o, shape, dtype in in_spec]
            shaped = jax.eval_shape(
                functools.partial(self._body, **static_kwargs), *shaped_args)
            entry = (in_spec, in_sections) + _build_spec(shaped)
            self._in_specs[key] = entry
        in_spec, in_sections, treedef, spec, sections = entry
        blob = pack_input_blob(allargs, in_spec, in_sections)
        out = self._jit_in(blob, in_spec=in_spec, in_sections=in_sections,
                           **static_kwargs)
        return BlobResult(out, treedef, spec, sections)

    def __call__(self, *args, **static_kwargs) -> BlobResult:
        # NOTE: a.dtype directly -- np.asarray(a) on a jax Array would fetch
        # it device->host just to read the dtype
        key = (tuple(sorted(static_kwargs.items())),
               tuple((tuple(a.shape), str(a.dtype)) for a in args))
        entry = self._specs.get(key)
        if entry is None:
            shaped = jax.eval_shape(
                functools.partial(self._body, **static_kwargs), *args)
            entry = _build_spec(shaped)
            self._specs[key] = entry
        treedef, spec, sections = entry
        blob = self._jit(*self._place(args), **static_kwargs)
        return BlobResult(blob, treedef, spec, sections)
