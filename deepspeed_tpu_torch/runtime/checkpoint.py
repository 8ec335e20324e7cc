"""Checkpoint save and load for engine state (the port of
``deepspeed_tpu/runtime/checkpoint.py``, on one process).

The layout under ``<save_dir>/<tag>/`` is the JAX package's, so a tag
passes between the packages either way:

- ``model_states.shard_0.npz`` + ``.json``: the fp32 master params, and a
  chunk manifest (each leaf's global shape, dtype and the index range of
  each saved chunk);
- ``optim_states.shard_0.npz`` + ``.json``: the optimizer state and the
  loss-scale group;
- ``meta.json``: the step counters, the lr schedule, client state;
- ``COMMITTED``: every file's size and CRC32, written last;
- ``<save_dir>/latest``: the tag pointer.

Leaf keys are the JAX package's strings: dict keys, sequence indices and
NamedTuple field names joined with ``/`` (``h_0/attn/qkvw``,
``opt_state/exp_avg/wte``, ``loss_scale/scale``). bf16 leaves are widened
to fp32 in the npz (it cannot hold bf16) under a ``bfloat16`` manifest
dtype. The port writes one chunk per leaf; it loads any chunk set, as a
JAX tag written by several devices holds (ZeRO's merge, then one shard).

Durability: every file is written to a temp name, fsynced and renamed,
and retried through ``fault.retry_io``; a save is visible only once its
directory holds the ``COMMITTED`` marker and is renamed from
``<tag>.tmp`` to ``<tag>``. Loading verifies the marker
(:func:`verify_checkpoint_dir`) and the engine falls back to the newest
committed tag when ``latest`` is torn or a shard is corrupt. Not ported:
the async writer and its device snapshots, and the multi-host gather.
"""

import glob
import io
import json
import os
import re
import shutil
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.runtime import fault
from deepspeed_tpu_torch.utils.tree import tree_map_with_path

LATEST = "latest"
COMMIT_MARKER = "COMMITTED"
TMP_SUFFIX = ".tmp"
OLD_SUFFIX = ".old"
CHECKPOINT_FORMAT_VERSION = 1

# process-global retry policy for transient filesystem errors; the
# engine sets it from the `checkpoint` config section
_RETRY = {"retries": 3, "backoff": 0.05}


def set_retry_policy(retries: Optional[int] = None,
                     backoff: Optional[float] = None) -> None:
    if retries is not None:
        _RETRY["retries"] = int(retries)
    if backoff is not None:
        _RETRY["backoff"] = float(backoff)


def _retry(fn):
    return fault.retry_io(fn, retries=_RETRY["retries"],
                          backoff=_RETRY["backoff"])


def _fsync_dir(dirpath: str) -> None:
    """Flush a directory's metadata (a rename) to stable storage; best
    effort where a directory cannot be opened."""
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write(path: str, write: Callable[[Any], None]) -> None:
    """``write(f)`` into a temp file, fsync, ``os.replace``: readers never
    see a torn file at ``path``. Retried on a transient ``OSError``."""
    def _write():
        fault.fire("io_write", path=path)
        tmp = path + ".part"
        with open(tmp, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(path) or ".")
    _retry(_write)


def _atomic_write_bytes(path: str, data: bytes) -> None:
    _atomic_write(path, lambda f: f.write(data))


def _npz_bytes(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


# ------------------------------------------------------------------ #
# trees: the JAX package's leaf keys over dicts, sequences, NamedTuples
# ------------------------------------------------------------------ #

def _map_named(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    """``tree`` rebuilt with each leaf replaced by ``fn(key, leaf)``, in
    JAX's leaf order; ``key`` is the JAX package's key string, the leaf's
    path joined with ``/``."""
    return tree_map_with_path(
        lambda path, leaf: fn("/".join(path) or "_root", leaf), tree)


def _flatten_named(tree: Any) -> Dict[str, Any]:
    """``{key: leaf}`` with the JAX package's key strings, in its leaf
    order."""
    flat: Dict[str, Any] = {}
    _map_named(flat.__setitem__, tree)
    return flat


def _dtype_name(v) -> str:
    """The manifest's dtype string (numpy's names: ``float32``,
    ``bfloat16``, ``int32``)."""
    if isinstance(v, torch.Tensor):
        return str(v.dtype).replace("torch.", "")
    return str(np.asarray(v).dtype)


def _host_array(v) -> np.ndarray:
    """A leaf as a host numpy array; bf16 (which npz cannot hold) widened
    to fp32."""
    if isinstance(v, torch.Tensor):
        t = v.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    arr = np.asarray(v)
    return arr.astype(np.float32) if arr.dtype.kind == "V" else arr


def _leaf_shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else \
        np.asarray(leaf).shape


def _np_dtype(leaf):
    """The numpy dtype a loaded leaf is assembled in: the template's,
    fp32 for a bf16 tensor (narrowed when the tensor is made)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return np.float32
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _as_template(buf: np.ndarray, leaf):
    """The assembled array in the template's kind: a CPU tensor of the
    template's dtype, or a numpy array (a scalar for a 0-d leaf)."""
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(buf).to(leaf.dtype)
    return buf if buf.shape else buf[()]


def save_tree(path: str, tree: Any) -> None:
    """A tree saved as one npz (the legacy single-file format)."""
    arrays = {k: _host_array(v) for k, v in _flatten_named(tree).items()}
    _atomic_write_bytes(path, _npz_bytes(arrays))


def load_tree(path: str, template: Any) -> Any:
    """A single-file npz restored into ``template``'s structure, each
    leaf in the template's dtype."""
    def _read():
        with np.load(path) as z:
            return dict(z)
    data = _retry(_read)

    def leaf(key, tmpl):
        if key not in data:
            raise KeyError(f"checkpoint missing leaf '{key}'")
        arr = data[key]
        if tuple(arr.shape) != _leaf_shape(tmpl):
            raise ValueError(f"shape mismatch for '{key}': ckpt "
                             f"{arr.shape} vs model {_leaf_shape(tmpl)}")
        return _as_template(np.asarray(arr).astype(_np_dtype(tmpl)), tmpl)
    return _map_named(leaf, template)


# ------------------------------------------------------------------ #
# the sharded format: a chunk manifest per process fragment
# ------------------------------------------------------------------ #

def save_tree_sharded(ckpt_dir: str, name: str, tree: Any) -> None:
    """Write ``<name>.shard_0.npz`` and its manifest ``.json``: one chunk
    per leaf, covering the whole leaf (the port trains on one process
    and one device). The npz streams into its file."""
    arrays: Dict[str, np.ndarray] = {}
    manifest: Dict[str, Any] = {}
    for key, v in _flatten_named(tree).items():
        arr = _host_array(v)
        ek = f"{key}::0"
        arrays[ek] = arr
        manifest[key] = {"global_shape": list(arr.shape),
                         "dtype": _dtype_name(v),
                         "chunks": [{"entry": ek, "start": [0] * arr.ndim,
                                     "stop": list(arr.shape)}]}
    _atomic_write(os.path.join(ckpt_dir, f"{name}.shard_0.npz"),
                  lambda f: np.savez(f, **arrays))
    _atomic_write_bytes(os.path.join(ckpt_dir, f"{name}.shard_0.json"),
                        json.dumps(manifest).encode())


def sharded_exists(ckpt_dir: str, name: str) -> bool:
    """True when a complete sharded save of ``name`` is present: every
    file the COMMITTED marker lists for it, or without a marker every
    manifest fragment with its npz."""
    marker = read_commit_marker(ckpt_dir)
    if marker is not None:
        listed = [f for f in marker["files"]
                  if f.startswith(f"{name}.shard_")]
        return bool(listed) and all(
            os.path.isfile(os.path.join(ckpt_dir, f)) for f in listed)
    frags = glob.glob(os.path.join(ckpt_dir, f"{name}.shard_*.json"))
    if not frags:
        return False
    return all(os.path.isfile(f[:-len(".json")] + ".npz") for f in frags)


def _merged_manifest(ckpt_dir: str, name: str):
    """Every fragment's manifest merged into ``{leaf: (shape, dtype,
    [(npz, entry, start, stop), ...])}``."""
    merged: Dict[str, Any] = {}
    frags = sorted(glob.glob(
        os.path.join(ckpt_dir, f"{name}.shard_*.json")))
    if not frags:
        raise FileNotFoundError(
            f"no {name}.shard_*.json manifests in {ckpt_dir}")
    for fpath in frags:
        npz = fpath[:-len(".json")] + ".npz"

        def _read(p=fpath):
            with open(p) as f:
                return json.load(f)
        for key, entry in _retry(_read).items():
            tgt = merged.setdefault(
                key, (tuple(entry["global_shape"]), entry["dtype"], []))
            for c in entry["chunks"]:
                tgt[2].append((npz, c["entry"], tuple(c["start"]),
                               tuple(c["stop"])))
    return merged


def load_tree_sharded(ckpt_dir: str, name: str, template: Any) -> Any:
    """Assemble a sharded save into ``template``'s structure from any
    chunk set: each leaf is filled chunk by chunk from its manifest, its
    coverage and shape checked, and cast to the template's dtype.
    Tensor leaves come back as CPU tensors (a template on the ``meta``
    device gives its shape and dtype only), the rest as numpy."""
    merged = _merged_manifest(ckpt_dir, name)
    npz_cache: Dict[str, Any] = {}

    def chunk(npz_path, entry):
        # a failed read drops the cached handle so the retry reopens it
        def _read():
            if npz_path not in npz_cache:
                npz_cache[npz_path] = np.load(npz_path)
            try:
                return npz_cache[npz_path][entry]
            except OSError:
                npz_cache.pop(npz_path, None)
                raise
        return _retry(_read)

    def leaf(key, tmpl):
        if key not in merged:
            raise KeyError(f"checkpoint missing leaf '{key}'")
        gshape, _dtype, chunks = merged[key]
        if tuple(gshape) != _leaf_shape(tmpl):
            raise ValueError(f"shape mismatch for '{key}': ckpt {gshape} "
                             f"vs model {_leaf_shape(tmpl)}")
        buf = np.empty(gshape, dtype=_np_dtype(tmpl))
        filled = 0
        for npz_path, entry, cs, ce in chunks:
            data = chunk(npz_path, entry)
            buf[tuple(slice(b, e) for b, e in zip(cs, ce))] = \
                data.astype(buf.dtype)
            filled += int(np.prod([e - b for b, e in zip(cs, ce)]))
        want = int(np.prod(gshape)) if gshape else 1
        if filled != want:
            raise ValueError(
                f"incomplete checkpoint coverage for '{key}': "
                f"{filled}/{want} elements (missing shard files?)")
        return _as_template(buf, tmpl)

    try:
        return _map_named(leaf, template)
    finally:
        for f in npz_cache.values():
            f.close()


def load_params_only(ckpt_dir: str, template: Any) -> Any:
    """The ``model_states`` group alone (never the optimizer state): what
    a serving engine needs from a training tag. Reads the sharded format
    or the legacy ``model_states.npz``."""
    if sharded_exists(ckpt_dir, "model_states"):
        return load_tree_sharded(ckpt_dir, "model_states", template)
    single = os.path.join(ckpt_dir, "model_states.npz")
    if os.path.isfile(single):
        return load_tree(single, template)
    raise FileNotFoundError(
        f"no model_states (sharded or single-file) in {ckpt_dir}")


# state groups a tag directory may carry, in report order
_STATE_GROUP_NAMES = ("model_states", "optim_states")


def state_groups(ckpt_dir: str) -> Dict[str, Any]:
    """``{group: "sharded" | "single-file" | None}`` for the array
    groups, ``cpu_optim_states`` and ``meta`` booleans, and the extra
    sealed files (``extras``)."""
    groups: Dict[str, Any] = {}
    for name in _STATE_GROUP_NAMES:
        if sharded_exists(ckpt_dir, name):
            groups[name] = "sharded"
        elif os.path.isfile(os.path.join(ckpt_dir, f"{name}.npz")):
            groups[name] = "single-file"
        else:
            groups[name] = None
    groups["cpu_optim_states"] = os.path.isfile(
        os.path.join(ckpt_dir, "cpu_optim_states.npz"))
    groups["meta"] = os.path.isfile(os.path.join(ckpt_dir, "meta.json"))
    known_prefixes = tuple(f"{n}.shard_" for n in _STATE_GROUP_NAMES)
    known = {COMMIT_MARKER, "meta.json", "cpu_optim_states.npz",
             "model_states.npz", "optim_states.npz"}
    extras = []
    if os.path.isdir(ckpt_dir):
        for fn in sorted(os.listdir(ckpt_dir)):
            if fn in known or fn.startswith(known_prefixes) or \
                    fn.endswith(".part"):
                continue
            if os.path.isfile(os.path.join(ckpt_dir, fn)):
                extras.append(fn)
    groups["extras"] = extras
    return groups


def write_meta(ckpt_dir: str, meta: Dict) -> None:
    _atomic_write_bytes(
        os.path.join(ckpt_dir, "meta.json"),
        json.dumps(meta, indent=2, default=str).encode())


def read_meta(ckpt_dir: str) -> Dict:
    def _read():
        with open(os.path.join(ckpt_dir, "meta.json")) as f:
            return json.load(f)
    return _retry(_read)


def write_latest(save_dir: str, tag: str) -> None:
    """Repoint ``latest`` atomically (temp + fsync + ``os.replace``)."""
    path = os.path.join(save_dir, LATEST)

    def _write():
        fault.fire("io_write", path=path)
        tmp = path + TMP_SUFFIX
        with open(tmp, "w") as f:
            f.write(tag)
            f.flush()
            os.fsync(f.fileno())
        fault.fire("ckpt.latest_tmp_written", path=path, tag=tag)
        os.replace(tmp, path)
        _fsync_dir(save_dir)
    _retry(_write)


def read_latest(save_dir: str) -> Optional[str]:
    p = os.path.join(save_dir, LATEST)
    if not os.path.isfile(p):
        return None
    with open(p) as f:
        tag = f.read().strip()
    return tag or None      # an empty pointer names no tag


# ------------------------------------------------------------------ #
# the commit protocol: the marker, verification, tag scan, retention
# ------------------------------------------------------------------ #

def write_commit_marker(ckpt_dir: str, process_count: int = 1) -> Dict:
    """Seal a checkpoint directory: the ``COMMITTED`` marker records
    every file's size and CRC32 (reading each file back), written
    last."""
    files: Dict[str, Dict[str, int]] = {}
    for fn in sorted(os.listdir(ckpt_dir)):
        p = os.path.join(ckpt_dir, fn)
        if fn == COMMIT_MARKER or fn.endswith(".part") or \
                not os.path.isfile(p):
            continue
        files[fn] = {"size": os.path.getsize(p),
                     "crc32": _retry(lambda p=p: fault.crc32_file(p))}
    marker = {"format_version": CHECKPOINT_FORMAT_VERSION,
              "process_count": int(process_count), "files": files}
    _atomic_write_bytes(os.path.join(ckpt_dir, COMMIT_MARKER),
                        json.dumps(marker, indent=2).encode())
    return marker


def read_commit_marker(ckpt_dir: str) -> Optional[Dict]:
    p = os.path.join(ckpt_dir, COMMIT_MARKER)
    if not os.path.isfile(p):
        return None
    try:
        with open(p) as f:
            marker = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None     # an unreadable marker is no commit
    if not isinstance(marker.get("files"), dict):
        return None
    return marker


def is_committed(ckpt_dir: str) -> bool:
    return read_commit_marker(ckpt_dir) is not None


def verify_checkpoint_dir(ckpt_dir: str,
                          check_crc: bool = True) -> Tuple[bool, List[str]]:
    """Integrity check of one tag directory, ``(ok, problems)``. With a
    marker, every listed file must exist with its size (and CRC32 unless
    ``check_crc=False``); without one (a save from before the marker),
    ``meta.json`` and a complete ``model_states`` must be there."""
    problems: List[str] = []
    if not os.path.isdir(ckpt_dir):
        return False, [f"{ckpt_dir}: not a directory"]
    marker = read_commit_marker(ckpt_dir)
    if marker is None:
        if not os.path.isfile(os.path.join(ckpt_dir, "meta.json")):
            problems.append("no COMMITTED marker and no meta.json "
                            "(incomplete or torn save)")
        if not (os.path.isfile(os.path.join(ckpt_dir, "model_states.npz"))
                or sharded_exists(ckpt_dir, "model_states")):
            problems.append("no complete model_states (single-file or "
                            "all shard fragments)")
        return not problems, problems
    for fn, info in marker["files"].items():
        p = os.path.join(ckpt_dir, fn)
        if not os.path.isfile(p):
            problems.append(f"{fn}: listed in COMMITTED but missing")
            continue
        size = os.path.getsize(p)
        if size != info.get("size"):
            problems.append(f"{fn}: size {size} != recorded "
                            f"{info.get('size')}")
            continue
        if check_crc and fault.crc32_file(p) != info.get("crc32"):
            problems.append(f"{fn}: CRC32 mismatch (corrupt bytes)")
    return not problems, problems


_STEP_RE = re.compile(r"(\d+)$")


def _tag_rank(fn: str) -> Tuple[int, int]:
    """(step, freshness): a ``<tag>.old`` leftover ranks by its base
    tag's step, below the live copy of that tag."""
    base = fn[:-len(OLD_SUFFIX)] if fn.endswith(OLD_SUFFIX) else fn
    m = _STEP_RE.search(base)
    step = int(m.group(1)) if m else -1
    return step, (0 if fn.endswith(OLD_SUFFIX) else 1)


def tag_step(fn: str) -> int:
    return _tag_rank(fn)[0]


def list_tags(save_dir: str) -> List[str]:
    """Tags newest first: by the step a tag's name ends in (``.old``
    leftovers by their base step), else by mtime. ``.tmp`` staging
    directories are never tags."""
    if not os.path.isdir(save_dir):
        return []
    ranked = []
    for fn in os.listdir(save_dir):
        p = os.path.join(save_dir, fn)
        if not os.path.isdir(p) or fn.endswith(TMP_SUFFIX):
            continue
        if not (os.path.isfile(os.path.join(p, COMMIT_MARKER))
                or os.path.isfile(os.path.join(p, "meta.json"))):
            continue
        step, fresh = _tag_rank(fn)
        ranked.append((step, fresh, os.path.getmtime(p), fn))
    ranked.sort(reverse=True)
    return [fn for _, _, _, fn in ranked]


def candidate_tags(save_dir: str) -> List[str]:
    """Resume candidates, best first. A healthy ``latest`` leads (it may
    name a custom tag such as ``best``), unless both it and another tag
    end in step numbers and the other is newer: that save committed and
    died before repointing ``latest``, so the newest step wins."""
    tags = list_tags(save_dir)
    latest = read_latest(save_dir)
    if not latest:
        return tags
    if latest not in tags:
        if os.path.isdir(os.path.join(save_dir, latest)):
            return [latest] + tags
        return tags
    lstep = tag_step(latest)
    if lstep >= 0 and any(tag_step(t) > lstep for t in tags):
        return tags
    return [latest] + [t for t in tags if t != latest]


def is_preemption_tag(ckpt_dir: str) -> bool:
    """True when ``meta.json`` says the preemption drain committed the
    tag (``preempted: true``)."""
    try:
        return bool(read_meta(ckpt_dir).get("preempted"))
    except (OSError, json.JSONDecodeError, ValueError):
        return False


def newest_committed_step(save_dir: str) -> int:
    """The step of the newest committed step-suffixed tag, -1 without
    one."""
    steps = [tag_step(t) for t in list_tags(save_dir)
             if tag_step(t) >= 0 and is_committed(os.path.join(save_dir, t))]
    return max(steps) if steps else -1


def gc_old_tags(save_dir: str, keep_n: int) -> List[str]:
    """Retention: delete the committed step-suffixed tags past the newest
    ``keep_n``. Custom-named tags are never touched, nor the tag
    ``latest`` names, nor a committed preemption tag newer than it, nor
    an uncommitted directory; ``keep_n <= 0`` keeps everything."""
    if keep_n <= 0:
        return []
    latest = read_latest(save_dir)
    lstep = tag_step(latest) if latest else -1
    managed = [t for t in list_tags(save_dir)
               if tag_step(t) >= 0
               and is_committed(os.path.join(save_dir, t))]
    doomed = []
    for t in managed[keep_n:]:
        if t == latest:
            continue
        if tag_step(t) > lstep and \
                is_preemption_tag(os.path.join(save_dir, t)):
            continue
        doomed.append(t)
    for t in doomed:
        shutil.rmtree(os.path.join(save_dir, t), ignore_errors=True)
    return doomed
