#!/usr/bin/env python
"""Offline checkpoint integrity checker (the port of
``tools/verify_checkpoint.py``, with its flags and exit codes; it imports
torch and numpy, never jax).

Verifies a checkpoint directory of either package without constructing
an engine: COMMITTED marker presence, per-file sizes + CRC32 checksums,
and a per-leaf chunk coverage report (every element of every leaf's
global shape accounted for by exactly the saved fragments — the
invariant the loader depends on, runtime/checkpoint.py
load_tree_sharded).

Usage::

    python -m deepspeed_tpu_torch.tools.verify_checkpoint <save_dir>
    python -m deepspeed_tpu_torch.tools.verify_checkpoint <save_dir> --tag TAG
    python -m deepspeed_tpu_torch.tools.verify_checkpoint <save_dir>/<tag>
    ... [--no-crc] [--all] [--expect-step N] [--serve-ready]

Exit status 0 iff everything checked is committed, verified, and fully
covered — and, with ``--expect-step N``, the newest committed
step-suffixed tag is at least step N (a supervisor's resume sanity
check). Exit status 2 when the path is not a directory or holds no tag.
Preemption-tagged checkpoints (``meta.preempted``) are reported
distinctly.
"""

import argparse
import json
import os
import sys

from deepspeed_tpu_torch.runtime import checkpoint as ckpt


def _leaf_coverage(ckpt_dir, name):
    """[(leaf, covered_elements, total_elements, n_chunks)] for one
    sharded pytree; chunk volumes are summed (fragments never overlap)."""
    rows = []
    merged = ckpt._merged_manifest(ckpt_dir, name)
    for key, (gshape, _dtype, chunks) in sorted(merged.items()):
        total = 1
        for d in gshape:
            total *= int(d)
        covered = 0
        for _npz, _entry, cs, ce in chunks:
            vol = 1
            for b, e in zip(cs, ce):
                vol *= max(0, int(e) - int(b))
            covered += vol if gshape else 1
        if not gshape:
            total = 1
        rows.append((key, covered, total, len(chunks)))
    return rows


def verify_tag_dir(ckpt_dir, check_crc=True, require_optim=True):
    """Print a report for one tag dir; return True iff healthy.

    ``require_optim=False`` (the ``--serve-ready`` preflight) accepts
    params-only tags: a weight push loads model_states and nothing
    else, so a missing optimizer group is by design there, not a gap.
    """
    print(f"== {ckpt_dir}")
    healthy = True
    marker = ckpt.read_commit_marker(ckpt_dir)
    if marker is None:
        print("  COMMITTED: absent (legacy/pre-durability or torn save)")
    else:
        print(f"  COMMITTED: format_version={marker.get('format_version')} "
              f"process_count={marker.get('process_count')} "
              f"files={len(marker['files'])}")
    ok, problems = ckpt.verify_checkpoint_dir(ckpt_dir, check_crc=check_crc)
    for p in problems:
        print(f"  PROBLEM: {p}")
        healthy = False
    if ok:
        print(f"  file integrity: OK "
              f"({'sizes+crc32' if check_crc and marker else 'sizes' if marker else 'legacy best-effort'})")
    # which state groups this tag carries — a params-only consumer
    # (InferenceEngine.from_checkpoint) needs model_states and nothing
    # else; a training resume needs optim_states (+ cpu_optim_states
    # under ZeRO-Offload) too
    groups = ckpt.state_groups(ckpt_dir)
    parts = []
    for name in ("model_states", "optim_states"):
        fmt = groups[name]
        parts.append(f"{name}({fmt})" if fmt else f"{name}(MISSING)")
    if groups["cpu_optim_states"]:
        parts.append("cpu_optim_states")
    if groups["meta"]:
        parts.append("meta")
    if groups["extras"]:
        parts.append(f"extras={groups['extras']}")
    print(f"  state groups: {', '.join(parts)}")
    if groups["model_states"] and not groups["optim_states"]:
        print("  note: params-only checkpoint (serving-loadable; not a "
              "training resume point)")
    for name in ("model_states", "optim_states"):
        try:
            rows = _leaf_coverage(ckpt_dir, name)
        except FileNotFoundError:
            if os.path.isfile(os.path.join(ckpt_dir, f"{name}.npz")):
                print(f"  {name}: legacy single-file format")
            else:
                print(f"  {name}: MISSING")
                if name == "model_states" or require_optim:
                    healthy = False
            continue
        except (json.JSONDecodeError, KeyError, ValueError, OSError) as e:
            # a torn/corrupt manifest is exactly what this tool exists to
            # catch — report it, don't traceback past the other tags
            print(f"  {name}: CORRUPT manifest ({e})")
            healthy = False
            continue
        bad = [(k, c, t) for k, c, t, _ in rows if c != t]
        print(f"  {name}: {len(rows)} leaves, "
              f"{sum(n for _, _, _, n in rows)} chunks")
        for k, c, t, n in rows:
            mark = "OK " if c == t else "GAP"
            print(f"    [{mark}] {k}: {c}/{t} elements in {n} chunk(s)")
        if bad:
            healthy = False
    meta_path = os.path.join(ckpt_dir, "meta.json")
    preempted = False
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        preempted = bool(meta.get("preempted"))
        print(f"  meta: global_step={meta.get('global_step')} "
              f"dp_world_size={meta.get('dp_world_size')} "
              f"zero_stage={meta.get('zero_stage')}")
        if preempted:
            print("  PREEMPTION checkpoint: committed by the graceful "
                  "drain — protected from retention GC while newer "
                  "than 'latest'")
    else:
        print("  meta.json: MISSING")
        healthy = False
    verdict = ('COMMITTED+VERIFIED' if healthy and marker
               else 'OK (legacy)' if healthy else 'CORRUPT/INCOMPLETE')
    if preempted and healthy:
        verdict += " (preemption)"
    print(f"  verdict: {verdict}")
    return healthy


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="save_dir or a single <save_dir>/<tag>")
    ap.add_argument("--tag", default=None, help="verify one tag of save_dir")
    ap.add_argument("--all", action="store_true",
                    help="verify every tag in save_dir")
    ap.add_argument("--no-crc", action="store_true",
                    help="skip checksum verification (sizes only)")
    ap.add_argument("--expect-step", type=int, default=None, metavar="N",
                    help="exit nonzero unless the newest committed "
                         "step-suffixed tag is at least step N (the "
                         "supervisor's resume sanity check)")
    ap.add_argument("--serve-ready", action="store_true",
                    help="exit nonzero unless every verified tag also "
                         "carries a model_states group — the fleet "
                         "swap-weights preflight (engine.swap_params "
                         "loads params-only)")
    args = ap.parse_args(argv)
    check_crc = not args.no_crc

    path = args.path.rstrip("/")
    if not os.path.isdir(path):
        print(f"error: {path} is not a directory", file=sys.stderr)
        return 2

    def check_serve_ready(tag_dir):
        """--serve-ready: a swap target must carry model_states (the
        only group the params-only serving loader reads)."""
        if ckpt.state_groups(tag_dir)["model_states"]:
            print(f"  serve-ready OK: {tag_dir} carries model_states")
            return True
        print(f"SERVE-READY FAILED: {tag_dir} has no model_states "
              "group — swap_params would find nothing to load",
              file=sys.stderr)
        return False

    # a tag dir directly (has a marker/meta and no nested tags)
    if args.tag is None and not args.all and (
            os.path.isfile(os.path.join(path, ckpt.COMMIT_MARKER))
            or os.path.isfile(os.path.join(path, "meta.json"))):
        ok = verify_tag_dir(path, check_crc,
                            require_optim=not args.serve_ready)
        if ok and args.serve_ready:
            ok = check_serve_ready(path)
        if ok and args.expect_step is not None:
            # meta is authoritative (custom-named tags like 'best' carry
            # no step in their name); the name is only a fallback
            step = ckpt.tag_step(os.path.basename(path))
            meta_path = os.path.join(path, "meta.json")
            if os.path.isfile(meta_path):
                with open(meta_path) as f:
                    step = int(json.load(f).get("global_step", step))
            if step < args.expect_step:
                print(f"EXPECT-STEP FAILED: tag step {step} < expected "
                      f"{args.expect_step}", file=sys.stderr)
                return 1
        return 0 if ok else 1

    tags = ckpt.list_tags(path)
    latest = ckpt.read_latest(path)
    print(f"save_dir {path}: {len(tags)} tag(s), latest={latest!r}")
    if args.tag is not None:
        targets = [args.tag]
    elif args.all:
        targets = tags
    else:
        if latest is None and not tags:
            print("no tags found", file=sys.stderr)
            return 2
        targets = [latest or tags[0]]
        if latest is not None and latest not in tags:
            print(f"  WARNING: latest names {latest!r} which is not a "
                  "loadable tag")
    rc = 0
    for t in targets:
        d = os.path.join(path, t)
        if not verify_tag_dir(d, check_crc,
                              require_optim=not args.serve_ready):
            rc = 1
        elif args.serve_ready and not check_serve_ready(d):
            rc = 1
    if args.expect_step is not None:
        newest = ckpt.newest_committed_step(path)
        if newest < args.expect_step:
            print(f"EXPECT-STEP FAILED: newest committed tag is step "
                  f"{newest} < expected {args.expect_step}",
                  file=sys.stderr)
            rc = rc or 1
        else:
            print(f"expect-step OK: newest committed tag is step {newest} "
                  f">= {args.expect_step}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
