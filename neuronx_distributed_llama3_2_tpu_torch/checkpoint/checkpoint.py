"""Checkpoint save / load / resume in the JAX package's on-disk format.

Counterpart of ``neuronx_distributed_llama3_2_tpu/checkpoint/checkpoint.py``.
A tag written by either package loads in the other, because the files are
the same:

- one ``.npy`` file per leaf of the JAX pytree, under
  ``{kind}/{key with "/" -> "."}.npy`` (kinds ``model`` and ``optim``);
- ``{kind}.manifest.json``, key -> ``file``, ``shape``, ``dtype``, keys in
  the JAX flatten order;
- bf16 stored as its ``uint16`` bit pattern under the dtype name
  ``"bfloat16"`` (npy has no bf16);
- ``scheduler.json``, ``user_content.json``, and ``meta.json`` with
  ``save_seq``; the ``checkpoint`` / ``done`` markers of :mod:`.storage`.

The keys are the paths the JAX package gives its ``TrainState``: the port's
parameters (a dict keyed by ``LlamaForCausalLM`` parameter names) are saved
in the JAX layout, each ``layers.<i>.<name>`` tensor written as layer ``i``
of one stacked ``(L, ...)`` ``layers/<name>`` leaf, and the port's
``OptimizerState`` under JAX's ``step`` / ``master`` / ``mu`` / ``nu``
names (``step`` as an int32 scalar; a ``master`` of None has no entries, as
in JAX, where None is an empty subtree). Nested dicts of tensors or numpy
arrays are saved by their key paths, as the JAX package saves any pytree.

Saving copies every tensor to host memory inside :meth:`CheckpointIOState.
add_tree`, before the caller's next train step updates the tensors in
place: one pass of non-blocking copies from the card into page-locked host
buffers (each stacked leaf written layer by layer into its preallocated
``(L, ...)`` buffer), one synchronize, then the files are written, on a
background thread under ``async_save``. The host buffers are kept per
checkpoint root and reused by the next save, which waits for the previous
one first.

Several processes (JAX ``:125-380``): each rank holds shards, which the
caller describes with the trees' specs (``model_specs`` /
``optimizer_specs``, :func:`..trainer.trainer.state_specs`), and every
entry is ``sharded``: a list of chunk files, one per distinct region of the
leaf over the mesh (JAX ``plan_chunk_writers`` / ``_chunk_plan``), each
written by the lowest rank holding it, under the JAX package's file names.
Rank 0 writes the manifests, ``meta.json`` and the markers; each rank
leaves ``done.shard.<nonce>.<rank>`` when its chunks are down, and rank 0
writes ``done`` only once it has seen all of them (JAX
``_wait_for_shard_markers``), the nonce agreed at ``begin`` so that an
old save's markers never count. A load with specs reads the region each
tensor of the rank needs from whichever files hold it (JAX
``_read_region``), so a tag saved at one (tp, dp) loads at another, and a
tag of either package, whole or chunked, loads on any mesh.

Under a pipeline each pp rank holds its stage's part of the tree: its
layers (one block, or the interleaved schedule's blocks) and the leaves its
stage uses. The tag stays in the canonical ``(L, ...)`` layout that JAX's
``examples/pretrain_llama.py`` saves a pipelined run in: each stage writes
one chunk file per layer block of its own, the first stage holding a leaf
writes the other leaves, and rank 0 writes the manifest of every rank's
entries (gathered from all of them), so the tag loads at any pp, in either
package.
"""

from __future__ import annotations

import atexit
import io
import os
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from neuronx_distributed_llama3_2_tpu_torch.checkpoint.storage import (
    BaseCheckpointStorage,
    FilesysCheckpointStorage,
    create_checkpoint_storage,
)
from neuronx_distributed_llama3_2_tpu_torch.parallel import layout as playout
from neuronx_distributed_llama3_2_tpu_torch.parallel.layout import LeafSpec
from neuronx_distributed_llama3_2_tpu_torch.utils.logger import get_logger

logger = get_logger()

_SEP = "/"
# the port's per-layer parameter names: "layers.<i>.<rest>"
_LAYERS = "layers"


# ---------------------------------------------------------------------------
# the port's trees in the JAX package's key layout
# ---------------------------------------------------------------------------

def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, int, float, bool, LeafSpec))


def _split_key(prefix: Tuple[str, ...], key) -> Tuple[Tuple[str, ...], Optional[int]]:
    """(JAX path, layer index) of one dict key under ``prefix``: a port
    parameter name ``layers.<i>.<rest>`` is layer ``i`` of the stacked
    ``layers/<rest>`` leaf; any other dotted name is a path (the port's
    names are the JAX paths with "." for "/")."""
    parts = str(key).split(".")
    if len(parts) > 2 and parts[0] == _LAYERS and parts[1].isdigit():
        return prefix + (_LAYERS, *parts[2:]), int(parts[1])
    return prefix + tuple(parts), None


def _walk(tree: Any, fn: Callable, prefix: Tuple[str, ...] = (),
          layer: Optional[int] = None) -> Any:
    """``tree`` rebuilt with each leaf replaced by ``fn(path, layer, leaf)``:
    dicts by key, named tuples by field (``OptimizerState``), lists and
    tuples by index; None stays None and has no leaves."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return fn(prefix, layer, tree)
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            path, idx = _split_key(prefix, k)
            out[k] = _walk(v, fn, path, idx if idx is not None else layer)
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[
            _walk(getattr(tree, f), fn, prefix + (f,), layer) for f in tree._fields
        ])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, prefix + (str(i),), layer) for i, v in enumerate(tree))
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} at {_SEP.join(prefix)!r}")


def _flatten(tree: Any) -> Dict[str, List[Tuple[Optional[int], Any]]]:
    """JAX key -> [(layer, leaf), ...] in the JAX flatten order (dict keys
    sorted at every level, named-tuple fields in order); a stacked leaf
    lists its layers in order, each once (0 .. L-1, or the layers a ZeRO-1
    rank or a pipeline stage holds)."""
    flat: Dict[Tuple[str, ...], list] = {}

    def visit(path, layer, leaf):
        flat.setdefault(path, []).append((layer, leaf))
        return leaf

    _walk(tree, visit)
    out: Dict[str, list] = {}
    for path in _jax_order(tree, list(flat)):
        items = flat[path]
        layers = [i for i, _ in items]
        if layers != [None]:
            if None in layers or len(set(layers)) != len(layers):
                raise ValueError(
                    f"{_SEP.join(path)}: layers {layers} are not distinct layers of the stack"
                )
            items = sorted(items, key=lambda it: it[0])
        out[_SEP.join(path)] = items
    return out


def _jax_order(tree: Any, paths: List[Tuple[str, ...]]) -> List[Tuple[str, ...]]:
    """``paths`` in the order ``jax.tree_util`` flattens them: dict keys
    sorted, named-tuple fields and sequence items in place."""

    def rank(path):
        node, i, out = tree, 0, []
        while i < len(path):
            if isinstance(node, Mapping):
                # a dotted key stands for nested dicts, whose keys JAX sorts
                # level by level: rank by the key's parts
                for k, v in node.items():
                    parts, _ = _split_key((), k)
                    if tuple(path[i:i + len(parts)]) == parts:
                        out.extend((0, p) for p in parts)
                        node, i = v, i + len(parts)
                        break
            elif isinstance(node, tuple) and hasattr(node, "_fields"):
                out.append((node._fields.index(path[i]), ""))
                node, i = getattr(node, path[i]), i + 1
            else:  # a list or tuple
                out.append((int(path[i]), ""))
                node, i = node[int(path[i])], i + 1
        return out

    return sorted(paths, key=rank)


def _torch_of(arr: np.ndarray, bf16: bool) -> torch.Tensor:
    """A CPU tensor over ``arr`` (bf16 from its uint16 bits)."""
    arr = np.require(arr, requirements="C")  # keeps 0-d arrays 0-d
    if bf16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _numpy_of(t: torch.Tensor) -> Tuple[np.ndarray, bool]:
    """(host numpy array, is bf16) of a CPU tensor; bf16 as its uint16 bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), True
    return t.numpy(), False


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def _from_npy(data: bytes) -> np.ndarray:
    return np.load(io.BytesIO(data), allow_pickle=False)


def _save_npy(storage: BaseCheckpointStorage, arr: np.ndarray, name: str) -> None:
    """Write ``arr`` as ``name``: straight into the file on a file-system
    root (no second copy of the array in memory), through the storage's
    bytes interface elsewhere. Both give the bytes ``np.save`` gives."""
    if isinstance(storage, FilesysCheckpointStorage):
        path = storage._p(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.save(f, arr, allow_pickle=False)
        os.replace(tmp, path)
    else:
        storage.save_bytes(_npy_bytes(arr), name)


def _load_npy(storage: BaseCheckpointStorage, name: str) -> np.ndarray:
    if isinstance(storage, FilesysCheckpointStorage):
        return np.load(storage._p(name), allow_pickle=False)
    return _from_npy(storage.load_bytes(name))


def _multi_process() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if _multi_process() else 0


def _is_writer() -> bool:
    """Only rank 0 touches the shared files (manifests, markers, GC,
    retention); every rank writes its own chunks."""
    return _rank() == 0


def _chunk_file(kind: str, key: str, index) -> str:
    """The JAX package's chunk file name, a function of the chunk's global
    index alone, so that every rank names a chunk alike."""
    span = "_".join(f"{a}-{b}" for a, b in index)
    return f"{kind}/{key.replace(_SEP, '.')}.shard.{span}.npy"


def _specs_by_key(specs: Any) -> Dict[str, LeafSpec]:
    """JAX key -> the LeafSpec of a specs tree shaped like the saved one."""
    if specs is None:
        return {}
    return {key: items[0][1] for key, items in _flatten(specs).items()}


def _mesh_sizes() -> Dict[str, int]:
    return {axis: size for axis, (_, size) in playout.mesh_coords().items()}


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

class CheckpointIOState:
    """Save lifecycle (JAX ``CheckpointIOState``): ``begin(tag)`` ->
    ``add_tree(kind, tree)`` (the copy to host happens HERE, before the
    caller's next step can overwrite the tensors) -> ``end()`` writes the
    files, on a background thread under ``async_save`` -> ``wait_all()``
    joins and re-raises the writer's error. ``done`` is written last."""

    def __init__(self, storage: BaseCheckpointStorage, async_save: bool = False):
        self.storage = storage
        self.async_save = async_save
        self._pending: List[threading.Thread] = []
        self._tag: Optional[str] = None
        self._work: List = []
        self._error: List[BaseException] = []
        self._nonce: Optional[str] = None
        # (kind, key) -> host buffer, reused save after save
        self._host: Dict[Tuple[str, str], torch.Tensor] = {}

    def begin(self, tag: str) -> None:
        self._tag = str(tag)
        self._work = []
        self._nonce = None
        if _is_writer():
            self.storage.makedirs(self._tag)
            # overwriting a completed tag: drop its done marker first, so that a
            # torn overwrite reads as incomplete
            self.storage.unmark_done(self._tag)
            self.storage.mark_checkpoint(self._tag)
        if _multi_process():
            # agree a fresh save generation; the broadcast doubles as the
            # barrier that keeps every rank from writing before rank 0 has
            # dropped the old done marker
            import uuid

            from neuronx_distributed_llama3_2_tpu_torch.parallel.multihost import (
                broadcast_from_host0,
            )

            self._nonce = broadcast_from_host0(uuid.uuid4().hex[:12])
            if not _is_writer():
                self.storage.makedirs(self._tag)

    def _host_buffer(self, kind: str, key: str, shape, dtype, pin: bool) -> torch.Tensor:
        buf = self._host.get((kind, key))
        if buf is None or tuple(buf.shape) != tuple(shape) or buf.dtype != dtype:
            buf = torch.empty(shape, dtype=dtype, pin_memory=pin)
            self._host[kind, key] = buf
        return buf

    def add_tree(self, kind: str, tree: Any, specs: Any = None) -> None:
        """Stage ``tree`` for ``kind``. Over several processes ``specs``
        (a tree of :class:`..parallel.layout.LeafSpec` shaped like
        ``tree``) says which part of each leaf the rank holds; a leaf
        without one is replicated."""
        if _multi_process():
            if specs is None:
                raise ValueError(
                    f"a save over several processes needs the specs of its {kind} "
                    "tree (model_specs / optimizer_specs): which part of each "
                    "leaf every rank holds"
                )
            return self._add_sharded(kind, tree, _specs_by_key(specs))
        manifest: Dict[str, Any] = {}
        staged: List[Tuple[str, str, Any]] = []  # (key, file, host tensor or array)
        on_card = False
        for key, items in _flatten(tree).items():
            fname = f"{kind}/{key.replace(_SEP, '.')}.npy"
            leaves = [leaf for _, leaf in items]
            if not isinstance(leaves[0], torch.Tensor):
                if items[0][0] is not None:
                    host = np.stack([np.asarray(x) for x in leaves])
                elif isinstance(leaves[0], (int, np.integer)) and not isinstance(leaves[0], bool):
                    host = np.asarray(leaves[0], np.int32)  # a JAX step is int32
                else:
                    host = np.asarray(leaves[0])
                staged.append((key, fname, host))
                continue
            stacked = items[0][0] is not None
            if stacked and [i for i, _ in items] != list(range(len(items))):
                raise ValueError(f"{key}: layers {[i for i, _ in items]} are not the whole "
                                 "stack (a part of the stack is saved over several processes)")
            first = leaves[0]
            shape = (len(leaves), *first.shape) if stacked else tuple(first.shape)
            pin = first.is_cuda
            on_card |= pin
            host = self._host_buffer(kind, key, shape, first.dtype, pin)
            with torch.no_grad():
                if stacked:
                    for i, t in enumerate(leaves):
                        host[i].copy_(t.detach(), non_blocking=pin)
                else:
                    host.copy_(first.detach(), non_blocking=pin)
            staged.append((key, fname, host))
        if on_card:
            torch.cuda.synchronize()
        host_files: Dict[str, np.ndarray] = {}
        for key, fname, host in staged:
            if isinstance(host, torch.Tensor):
                arr, bf16 = _numpy_of(host)
            else:
                arr, bf16 = host, False
            manifest[key] = {
                "file": fname,
                "shape": list(arr.shape),
                "dtype": "bfloat16" if bf16 else str(arr.dtype),
            }
            host_files[fname] = arr
        self._work.append((kind, manifest, host_files))

    def _add_sharded(self, kind: str, tree: Any, specs: Dict[str, LeafSpec]) -> None:
        """One process's part of a multi-process save: the manifest lists
        every chunk of every leaf (each rank's entries, gathered, so that
        rank 0 lists the leaves of every pipeline stage), and this rank
        stages the chunks it writes (module docstring)."""
        coords = playout.mesh_coords()
        sizes = _mesh_sizes()
        manifest: Dict[str, Any] = {}
        staged: List[Tuple[str, Any]] = []
        on_card = False
        for key, items in _flatten(tree).items():
            leaves = [leaf for _, leaf in items]
            stacked = items[0][0] is not None
            first = leaves[0]
            if not isinstance(first, torch.Tensor):
                first = torch.as_tensor(np.asarray(first, np.int32) if isinstance(first, (int, np.integer))
                                        and not isinstance(first, bool) else np.asarray(first))
                leaves = [first]
            leaf_spec = specs.get(key)
            if leaf_spec is None:  # replicated, whole on every rank
                shape = ((len(leaves),) if stacked else ()) + tuple(first.shape)
                leaf_spec = LeafSpec(shape, (None,) * len(shape), stacked)
            bf16 = first.dtype == torch.bfloat16
            manifest[key] = {
                "sharded": True,
                "chunks": [{"file": _chunk_file(kind, key, reg), "index": [list(p) for p in reg]}
                           for reg in playout.all_regions(leaf_spec, sizes)],
                "shape": list(leaf_spec.shape),
                "dtype": "bfloat16" if bf16 else str(torch.empty((), dtype=first.dtype).numpy().dtype),
            }
            if not playout.is_writer(leaf_spec, coords):
                continue
            by_layer = dict(items) if stacked else {}
            for reg in playout.regions(leaf_spec, coords):
                if stacked:
                    want = list(range(*reg[0]))
                    if any(i not in by_layer for i in want):
                        raise ValueError(f"{key}: this rank holds layers {sorted(by_layer)}, "
                                         f"its region is {reg[0]}")
                    part = [by_layer[i] for i in want]
                shape = tuple(b - a for a, b in reg)
                pin = first.is_cuda
                on_card |= pin
                host = self._host_buffer(kind, f"{key}@{reg[0][0] if reg else 0}", shape,
                                         first.dtype, pin)
                with torch.no_grad():
                    if stacked:
                        for i, t in enumerate(part):
                            host[i].copy_(t.detach(), non_blocking=pin)
                    else:
                        host.copy_(first.detach().reshape(shape), non_blocking=pin)
                staged.append((_chunk_file(kind, key, reg), host))
        if on_card:
            torch.cuda.synchronize()
        files = {fname: _numpy_of(host)[0] for fname, host in staged}
        self._work.append((kind, _gathered_manifest(manifest, specs), files))

    def add_json(self, name: str, obj: Any) -> None:
        self._work.append((name, None, obj))

    def end(self, save_seq: int, num_kept_ckpts: Optional[int] = None) -> None:
        tag, work, storage, nonce = self._tag, self._work, self.storage, self._nonce
        writer, rank = _is_writer(), _rank()
        multi = nonce is not None
        nproc = _world()

        def write():
            try:
                for kind, manifest, payload in work:
                    if manifest is None:
                        if writer:
                            storage.save_json(payload, f"{tag}/{kind}.json")
                        continue
                    for fname, arr in payload.items():
                        _save_npy(storage, arr, f"{tag}/{fname}")
                    if writer:
                        storage.save_json(manifest, f"{tag}/{kind}.manifest.json")
                if multi:
                    # this rank's chunks are down: say so through the files
                    # (no collective on a writer thread)
                    storage.save_text("ok", f"{tag}/done.shard.{nonce}.{rank}")
                if not writer:
                    return
                storage.save_json(
                    {"save_seq": save_seq, "saved_at": time.time(), "process_count": nproc},
                    f"{tag}/meta.json",
                )
                if multi:
                    _wait_for_shard_markers(storage, tag, nonce, nproc)
                storage.mark_done(tag)
                logger.info("checkpoint tag %s complete", tag)
                if num_kept_ckpts is not None:
                    _apply_retention(storage, num_kept_ckpts)
            except BaseException as e:  # surfaced on wait_all()
                self._error.append(e)
                raise

        if self.async_save:
            t = threading.Thread(target=write, name=f"ckpt-save-{tag}", daemon=False)
            t.start()
            self._pending.append(t)
        else:
            write()
        self._tag, self._work = None, []

    def wait_all(self) -> None:
        for t in self._pending:
            t.join()
        self._pending = []
        if self._error:
            err = self._error[:]
            self._error = []
            raise RuntimeError(f"async checkpoint save failed: {err[0]}") from err[0]


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if _multi_process() else 1


def _gathered_manifest(manifest: Dict[str, Any], specs: Dict[str, LeafSpec]) -> Dict[str, Any]:
    """Every rank's manifest entries in one manifest, in the JAX flatten
    order of ``specs`` (a pipeline stage lists only the leaves it holds)
    and the entries of ``specs``-less keys after them. Every rank calls
    it."""
    import torch.distributed as dist

    if playout.mesh_coords()[playout.parallel_state.PP_AXIS][1] == 1:
        return manifest
    parts: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(parts, manifest)
    merged: Dict[str, Any] = {}
    for part in parts:
        for key, entry in part.items():
            merged.setdefault(key, entry)
    order = [k for k in specs if k in merged] + [k for k in merged if k not in specs]
    return {k: merged[k] for k in order}


def _wait_for_shard_markers(storage: BaseCheckpointStorage, tag: str, nonce: str,
                            nproc: int) -> None:
    """Rank 0 waits until every rank's ``done.shard.<nonce>.<rank>`` is
    visible (JAX ``_wait_for_shard_markers``): ``done`` must appear only
    once every chunk of every rank is down. ``NXDT_CKPT_SYNC_TIMEOUT_S``
    (600 by default) bounds the wait."""
    timeout = float(os.environ.get("NXDT_CKPT_SYNC_TIMEOUT_S", "600"))
    deadline = time.monotonic() + timeout
    missing = set(range(nproc))
    while missing:
        missing = {i for i in missing if not storage.file_exists(f"{tag}/done.shard.{nonce}.{i}")}
        if not missing:
            return
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"checkpoint {tag}: ranks {sorted(missing)} never finished their "
                f"shard writes within {timeout:.0f}s"
            )
        time.sleep(0.05)


_IO_STATES: Dict[str, CheckpointIOState] = {}


def _io_state(storage: BaseCheckpointStorage, async_save: bool) -> CheckpointIOState:
    """One IO state per checkpoint root for the life of the process, as in
    the JAX package: replacing it would orphan an in-flight writer, whose
    tag the next save's GC would then delete mid-write."""
    key = storage.dirname()
    st = _IO_STATES.get(key)
    if st is None:
        st = CheckpointIOState(storage, async_save)
        _IO_STATES[key] = st
    else:
        st.async_save = async_save
    return st


def finalize_async_saves() -> None:
    """Join every pending async save (also run at interpreter exit)."""
    for st in _IO_STATES.values():
        st.wait_all()


atexit.register(finalize_async_saves)


def save_checkpoint(
    path: str,
    tag: str,
    model: Any = None,
    optimizer: Any = None,
    scheduler: Any = None,
    user_content: Any = None,
    async_save: bool = False,
    num_kept_ckpts: Optional[int] = None,
    model_specs: Any = None,
    optimizer_specs: Any = None,
) -> None:
    """Save under ``path/tag/``: ``model`` (the port's parameters, a dict
    keyed by parameter name, or any nested dict of tensors / arrays),
    ``optimizer`` (the port's ``OptimizerState``), ``scheduler`` and
    ``user_content`` (JSON). Waits for the root's previous async save,
    collects incomplete tags, then saves; ``num_kept_ckpts`` keeps that
    many completed tags, the newest. Over several processes every rank
    calls it, with ``model_specs`` / ``optimizer_specs`` (the train state's
    specs, :func:`..trainer.trainer.state_specs`) saying which part of each
    leaf the rank holds; the chunks it writes are its own."""
    if num_kept_ckpts is not None and num_kept_ckpts < 1:
        raise ValueError(
            f"num_kept_ckpts must be >= 1 (or None for keep-all), got {num_kept_ckpts}"
        )
    storage = create_checkpoint_storage(path)
    io_state = _io_state(storage, async_save)
    io_state.wait_all()  # one in-flight async save per root
    save_seq = 0
    if _is_writer():
        storage.makedirs("")
        # GC only after the in-flight save completed: an in-progress tag looks
        # exactly like an interrupted one
        storage.garbage_collect_incomplete()
        done = storage.list_tags()
        if done:
            try:
                save_seq = storage.load_json(f"{done[-1]}/meta.json").get("save_seq", 0) + 1
            except Exception:
                save_seq = len(done)
    io_state.begin(tag)
    if model is not None:
        io_state.add_tree("model", model, model_specs)
    if optimizer is not None:
        io_state.add_tree("optim", optimizer, optimizer_specs)
    if scheduler is not None:
        io_state.add_json("scheduler", scheduler)
    if user_content is not None:
        io_state.add_json("user_content", user_content)
    io_state.end(save_seq, num_kept_ckpts=num_kept_ckpts)


def _apply_retention(storage: BaseCheckpointStorage, keep: int) -> None:
    tags = storage.list_tags()
    for tag in tags[:-keep] if keep > 0 else []:
        logger.info("retention: removing old checkpoint tag %s", tag)
        storage.remove_tag(tag)


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------

def _resolve_tag(storage: BaseCheckpointStorage, tag: str) -> Optional[str]:
    if tag in ("latest", "latest_if_exists"):
        tags = storage.list_tags()
        if not tags:
            if tag == "latest_if_exists":
                return None
            raise FileNotFoundError(f"no completed checkpoint under {storage.dirname()}")
        return tags[-1]
    if not storage.is_done(tag):
        if tag.endswith("_if_exists"):
            return None
        raise FileNotFoundError(
            f"checkpoint tag {tag!r} not found/complete under {storage.dirname()}"
        )
    return tag


def _read_region(
    storage: BaseCheckpointStorage,
    tag: str,
    entry: Dict,
    region: tuple,
    cache: Dict[str, np.ndarray],
) -> np.ndarray:
    """Assemble one global-index region ((start, stop) per dim) of a
    ``sharded`` entry from the chunk files that intersect it; raises if the
    chunks leave a hole."""
    shape = [b - a for a, b in region]
    np_dtype = np.uint16 if entry["dtype"] == "bfloat16" else np.dtype(entry["dtype"])
    out = np.empty(shape, np_dtype)
    covered = 0
    for chunk in entry["chunks"]:
        cidx = [tuple(p) for p in chunk["index"]]
        inter = [(max(ra, ca), min(rb, cb)) for (ra, rb), (ca, cb) in zip(region, cidx)]
        if any(a >= b for a, b in inter):
            continue
        arr = cache.get(chunk["file"])
        if arr is None:
            arr = _load_npy(storage, f"{tag}/{chunk['file']}")
            cache[chunk["file"]] = arr
        src = tuple(slice(a - ca, b - ca) for (a, b), (ca, _) in zip(inter, cidx))
        dst = tuple(slice(a - ra, b - ra) for (a, b), (ra, _) in zip(inter, region))
        out[dst] = arr[src]
        covered += int(np.prod([b - a for a, b in inter]))
    if covered != int(np.prod(shape)):
        raise ValueError(
            f"checkpoint chunks do not cover requested region {region} "
            f"(covered {covered} of {int(np.prod(shape))} elements)"
        )
    return out


def _read_entry(storage: BaseCheckpointStorage, tag: str, entry: Dict) -> np.ndarray:
    """The whole array of one manifest entry (bf16 as its uint16 bits)."""
    if entry.get("sharded"):
        shape = tuple(entry["shape"])
        return _read_region(storage, tag, entry, tuple((0, d) for d in shape), {})
    return _load_npy(storage, f"{tag}/{entry['file']}")


def _load_region(storage: BaseCheckpointStorage, tag: str, entry: Dict, region: tuple,
                 cache: Dict) -> np.ndarray:
    """One global region of an entry, whole-file or chunked."""
    if entry.get("sharded"):
        return _read_region(storage, tag, entry, region, cache)
    arr = cache.get(entry["file"])
    if arr is None:
        name = f"{tag}/{entry['file']}"
        if isinstance(storage, FilesysCheckpointStorage):
            arr = np.load(storage._p(name), mmap_mode="r", allow_pickle=False)
        else:
            arr = _load_npy(storage, name)
        cache[entry["file"]] = arr
    return np.asarray(arr[tuple(slice(a, b) for a, b in region)])


def _load_parts(storage: BaseCheckpointStorage, tag: str, kind: str, template: Any,
                specs: Any) -> Any:
    """Each template tensor filled with the region of its leaf this rank
    holds by ``specs`` on the live mesh, from whichever files hold it."""
    manifest = storage.load_json(f"{tag}/{kind}.manifest.json")
    by_key = _specs_by_key(specs)
    coords = playout.mesh_coords()
    cache: Dict = {}

    def load(path, layer, tmpl):
        key = _SEP.join(path)
        entry = manifest.get(key)
        if entry is None:
            raise KeyError(f"checkpoint {tag}/{kind} missing tensor {key!r}")
        leaf = by_key.get(key)
        if leaf is None:
            shape = tuple(entry["shape"])
            leaf = LeafSpec(shape, (None,) * len(shape), layer is not None)
        if list(entry["shape"]) != list(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: checkpoint {entry['shape']} "
                             f"vs expected {list(leaf.shape)}")
        reg = playout.region(leaf, coords, layer)
        arr = _load_region(storage, tag, entry, reg, cache)
        if layer is not None:
            arr = arr[0]
        bf16 = entry["dtype"] == "bfloat16"
        if isinstance(tmpl, torch.Tensor):
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(f"shape mismatch for {key}: region {tuple(arr.shape)} vs "
                                 f"template {tuple(tmpl.shape)}")
            # a copy: a whole-file entry's region is a view of its read-only
            # memory map, which the caller's in-place updates must not reach
            return _torch_of(arr, bf16).to(device=tmpl.device, dtype=tmpl.dtype, copy=True)
        if isinstance(tmpl, (bool, int, float)):
            return type(tmpl)(arr)
        return np.asarray(arr, dtype=np.asarray(tmpl).dtype)

    return _walk(template, load)


def _load_tree(storage: BaseCheckpointStorage, tag: str, kind: str, template: Any,
               specs: Any = None) -> Any:
    if specs is not None:
        return _load_parts(storage, tag, kind, template, specs)
    manifest = storage.load_json(f"{tag}/{kind}.manifest.json")
    flat = _flatten(template)
    arrays: Dict[str, Tuple[np.ndarray, bool]] = {}

    def array(key: str) -> Tuple[np.ndarray, bool]:
        got = arrays.get(key)
        if got is None:
            entry = manifest.get(key)
            if entry is None:
                raise KeyError(f"checkpoint {tag}/{kind} missing tensor {key!r}")
            arr = _read_entry(storage, tag, entry)
            items = flat[key]
            want = list(np.shape(items[0][1]))
            if items[0][0] is not None:
                want = [len(items)] + want
            if list(arr.shape) != want:
                raise ValueError(
                    f"shape mismatch for {key}: checkpoint {list(arr.shape)} vs "
                    f"expected {want}"
                )
            got = arrays[key] = (arr, entry["dtype"] == "bfloat16")
        return got

    def load(path, layer, tmpl):
        arr, bf16 = array(_SEP.join(path))
        if layer is not None:
            arr = arr[layer]
        if isinstance(tmpl, torch.Tensor):
            return _torch_of(arr, bf16).to(device=tmpl.device, dtype=tmpl.dtype)
        if bf16:
            raise TypeError(f"{_SEP.join(path)}: a bf16 leaf needs a torch template")
        if isinstance(tmpl, (bool, int, float)):
            return type(tmpl)(arr)
        return np.asarray(arr, dtype=np.asarray(tmpl).dtype)

    return _walk(template, load)


def load_checkpoint(
    path: str,
    tag: str = "latest",
    model: Any = None,
    optimizer: Any = None,
    model_specs: Any = None,
    optimizer_specs: Any = None,
) -> Optional[Dict[str, Any]]:
    """Load a tag written by either package. ``model`` / ``optimizer`` are
    templates (the port's own parameters and ``OptimizerState``, or any
    tree shaped like the saved one): each leaf comes back as a new tensor
    on the template's device and in its dtype (an int stays an int). With
    ``model_specs`` / ``optimizer_specs`` each tensor is the part of its
    leaf this rank holds on the live mesh, read from whichever files hold it
    (a tag saved at another tp or dp included).
    Returns {"model", "optimizer", "scheduler", "user_content", "tag"} with
    the requested kinds and the JSON files present, or None for
    ``latest_if_exists`` / ``*_if_exists`` when there is no such tag."""
    storage = create_checkpoint_storage(path)
    resolved = _resolve_tag(storage, tag)
    if resolved is None:
        return None
    result: Dict[str, Any] = {"tag": resolved}
    if model is not None:
        result["model"] = _load_tree(storage, resolved, "model", model, model_specs)
    if optimizer is not None:
        result["optimizer"] = _load_tree(storage, resolved, "optim", optimizer, optimizer_specs)
    if storage.file_exists(f"{resolved}/scheduler.json"):
        result["scheduler"] = storage.load_json(f"{resolved}/scheduler.json")
    if storage.file_exists(f"{resolved}/user_content.json"):
        result["user_content"] = storage.load_json(f"{resolved}/user_content.json")
    return result


def copy_checkpoint(
    src_path: str,
    src_tag: str,
    dst_path: str,
    dst_tag: Optional[str] = None,
) -> str:
    """Copy a complete tag between roots (file system and S3, or a new tag
    name) without a template: every file verbatim, each array's shape
    checked against its manifest entry (a chunk's against its index), the
    marker protocol replayed at the destination. Returns the destination
    tag."""
    src = create_checkpoint_storage(src_path)
    resolved = _resolve_tag(src, src_tag)
    if resolved is None:
        raise FileNotFoundError(f"no checkpoint tag {src_tag!r} under {src.dirname()}")
    dst_tag = dst_tag or resolved
    dst = create_checkpoint_storage(dst_path)
    dst.makedirs(dst_tag)
    dst.unmark_done(dst_tag)
    dst.mark_checkpoint(dst_tag)
    copied = 0
    for kind in ("model", "optim"):
        mf_name = f"{resolved}/{kind}.manifest.json"
        if not src.file_exists(mf_name):
            continue
        manifest = src.load_json(mf_name)
        for key, entry in manifest.items():
            if entry.get("none"):
                continue
            if entry.get("sharded"):
                files = [(c["file"], [b - a for a, b in c["index"]], "index says")
                         for c in entry["chunks"]]
            else:
                files = [(entry["file"], list(entry["shape"]), "manifest says")]
            for fname, want, says in files:
                data = src.load_bytes(f"{resolved}/{fname}")
                arr = _from_npy(data)  # validates the npy framing
                if list(arr.shape) != want:
                    raise ValueError(
                        f"corrupt checkpoint: {key} ({fname}) has shape "
                        f"{list(arr.shape)} but its {says} {want}"
                    )
                dst.save_bytes(data, f"{dst_tag}/{fname}")
                copied += 1
        dst.save_json(manifest, f"{dst_tag}/{kind}.manifest.json")
    for extra in ("scheduler.json", "user_content.json", "meta.json"):
        name = f"{resolved}/{extra}"
        if src.file_exists(name):
            dst.save_json(src.load_json(name), f"{dst_tag}/{extra}")
    dst.mark_done(dst_tag)
    logger.info("copied checkpoint %s/%s -> %s/%s (%d tensors)",
                src.dirname(), resolved, dst.dirname(), dst_tag, copied)
    return dst_tag
