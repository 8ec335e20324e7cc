"""Check that a change to a kernel body shared by several kernels leaves
the others as they were, against a reference checkout of the repo.

``sass``: builds each named source in both checkouts, each with its own
``_build`` into its own build directory, dumps both libraries with
``cuobjdump -sass`` and compares them function by function, after
normalising the anonymous namespace's hash in the names
(``_GLOBAL__N__<hex>_``), which follows the source's path and contents. One JSON line per source; exit 1 if any differs.

``time``: times the kernels that run one of the shared tensor-core
bodies in both checkouts on one card, in turns (reference, change,
change, reference; ``--rounds`` times), each in a process of its own:
the median of CUDA-event timed calls, the L2 flushed before each, at the
shapes of ``chip_smoke.py``'s timing phases. One JSON line per kernel.
``--bodies fwd`` (the default) times those on K1's forward body (K1
causal, with a key mask and in its band arity, K5, K8, K14 with both
masks, with the key mask and without masks at the s8k geometry);
``--bodies bwd`` those on K2's dq and K3's dk/dv bodies at the same
calls (K2 and K3, K6 and K7, K9 and K10, K15 and K16), each fed its
forward's lse and delta.

Both need a CUDA machine (``nvcc``, ``cuobjdump``, a card):

    python3 -m deepspeed_tpu_torch.ops.body_check --old REF sass \\
        masked_flash.cu flash.cu
    python3 -m deepspeed_tpu_torch.ops.body_check --old REF time \\
        --bodies bwd

where ``REF`` holds the reference's ``deepspeed_tpu_torch`` package (for
example ``git archive <commit> deepspeed_tpu_torch`` unpacked), run from
the root of the changed checkout.
"""

import argparse
import difflib
import json
import os
import re
import subprocess
import sys
from typing import Dict

from deepspeed_tpu_torch.ops._build import _nvcc

_HASH = re.compile(r"_GLOBAL__N__[0-9a-fA-F]+_")
_FUNCTION = re.compile(r"^\s*Function : (\S+)\s*$")
_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/")
_COMMENT = re.compile(r"/\*.*?\*/")
SOURCES = ("masked_flash.cu", "flash.cu", "blocksparse_v2.cu",
           "blocksparse.cu")


def functions(sass: str) -> Dict[str, str]:
    """{normalised function name: its SASS} of one ``cuobjdump -sass``
    listing."""
    out, name, body = {}, None, []
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            if name is not None:
                out[name] = "\n".join(body)
            name, body = _HASH.sub("_GLOBAL__N__", m.group(1)), []
        elif name is not None:
            body.append(_HASH.sub("_GLOBAL__N__", line.rstrip()))
    if name is not None:
        out[name] = "\n".join(body)
    return out


def _instructions(body: str) -> int:
    return len(_INSTRUCTION.findall(body))


def compare(old: Dict[str, str], new: Dict[str, str]) -> dict:
    same = sorted(n for n in old if new.get(n) == old[n])
    differ = sorted(n for n in old if n in new and new[n] != old[n])
    return {"functions_old": len(old), "functions_new": len(new),
            "identical": len(same), "differ": differ,
            # instructions summed over the functions that differ
            "differ_instructions_old": sum(_instructions(old[n])
                                           for n in differ),
            "differ_instructions_new": sum(_instructions(new[n])
                                           for n in differ),
            "only_old": sorted(set(old) - set(new)),
            "only_new": sorted(set(new) - set(old)),
            "same_order": list(old) == list(new) and len(same) == len(old)}


def _build_both(old_root: str, sources) -> Dict[str, Dict[str, str]]:
    """{"old" | "new": {source: library}}: each tree's sources built by its
    own ``_build`` into its own build directory, both trees at once."""
    roots = {"old": os.path.abspath(old_root), "new": os.getcwd()}
    procs = {tree: subprocess.Popen(
        [sys.executable, "-c",
         "import json, sys; sys.path.insert(0, sys.argv[1]); "
         "from deepspeed_tpu_torch.ops._build import build_all; "
         "print(json.dumps(build_all(sys.argv[2:])))", root, *sources],
        stdout=subprocess.PIPE, text=True) for tree, root in roots.items()}
    out = {}
    for tree, p in procs.items():
        stdout, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"the {tree} tree's build failed")
        out[tree] = json.loads(stdout.strip().splitlines()[-1])
        if not all(path.startswith(roots[tree]) for path in
                   out[tree].values()):
            raise RuntimeError(f"the {tree} build left its tree")
    return out


def _text(body: str):
    """A function's instructions without addresses and encodings."""
    lines = (_COMMENT.sub("", line).strip() for line in body.splitlines())
    return [line for line in lines if line]


def sass(old_root: str, sources, show: int = 0) -> int:
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    libs = _build_both(old_root, sources)
    ok = True
    for src in sources:
        old, new = (functions(subprocess.run(
            [cuobjdump, "-sass", libs[tree][src]], check=True,
            capture_output=True, text=True).stdout)
            for tree in ("old", "new"))
        row = {"source": src, **compare(old, new)}
        ok &= not (row["differ"] or row["only_old"] or row["only_new"])
        if show and row["differ"]:
            # the instruction diff of the first function that differs
            name = row["differ"][0]
            row["diff_of"] = name
            row["diff"] = list(difflib.unified_diff(
                _text(old[name]), _text(new[name]), lineterm="", n=1))[:show]
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


# one timing process: argv = [package root, repo root, "fwd" or "bwd"];
# prints {name: ms}
_WORKER = r'''
import json, sys
sys.path[:0] = sys.argv[1:3]
import numpy as np
import torch
import chip_smoke as c
import deepspeed_tpu_torch
from deepspeed_tpu_torch.ops.attention import flash as fl
from deepspeed_tpu_torch.ops.attention import masked_flash as mf
from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as bs
from deepspeed_tpu_torch.ops.sparse_attention import blocksparse_v2 as v2
from deepspeed_tpu_torch.ops.sparse_attention.blocksparse import (
    NEG_INF, _to_additive)
bf = torch.bfloat16
rng = np.random.RandomState(c.SEED + 1)
flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
m = c.MAIN_SHAPE
q, k, v, do = c.train_inputs(rng, m["B"], m["H"], m["Hkv"], m["S"],
                             m["D"], bf)
sc = 1.0 / float(np.sqrt(m["D"]))
causal = mf.BlockMask.causal(m["S"], m["block"])
b = c.BERT_SHAPE
qb, kb, vb, dob = c.train_inputs(rng, b["B"], b["H"], b["Hkv"], b["S"],
                                 b["D"], bf)
kpm_b = c.bert_key_mask(rng, b["B"], b["S"], 64)
dense_b = mf.BlockMask.dense(b["S"], b["S"], b["block"])
s = c.V2_SHAPE
qs, ks, vs, dos = c.train_inputs(rng, s["B"], s["H"], s["H"], s["S"],
                                 s["D"], bf)
kpm_s = c.bert_key_mask(rng, s["B"], s["S"], c.SPARSE_MIN_LEN, pad=NEG_INF)
am = _to_additive(c.v2_mask(rng, s["S"]), "mul")
fixed = c.sparse_config("fixed", heads=s["H"]).make_layout(s["S"])
band = c.sparse_config("bslongformer", heads=s["H"]).make_block_mask(
    s["S"], walk_block=128)
v2_plan = c.v2_plan(fixed, 16)
tiles = v2_plan.mask_tiles(am)
v1_plan = bs.TriplePlan(fixed, 16)
e = c.S8K_SHAPE
q8, k8, v8, do8 = c.train_inputs(rng, e["B"], e["H"], e["H"], e["S"],
                                 e["D"], bf)
lf_plan = bs.TriplePlan(c.s8k_config("lf", e["H"]).make_layout(e["S"]), 128)
calls = {
    "masked_flash_fwd causal": lambda: mf.masked_flash_fwd(q, k, v, causal,
                                                           sc),
    "masked_flash_fwd kpm S128": lambda: mf.masked_flash_fwd(
        qb, kb, vb, dense_b, sc, key_mask=kpm_b),
    "masked_flash_fwd band walk128": lambda: mf.masked_flash_fwd(
        qs, ks, vs, band, sc, key_mask=kpm_s),
    "flash_fwd causal": lambda: fl.flash_fwd(q, k, v, True, sc),
    "blocksparse_v2_fwd": lambda: v2.blocksparse_v2_fwd(
        qs, ks, vs, kpm_s, tiles, v2_plan, sc),
    "bs_fwd am kpm": lambda: bs.bs_fwd(qs, ks, vs, kpm_s, am, v1_plan, sc),
    "bs_fwd kpm": lambda: bs.bs_fwd(qs, ks, vs, kpm_s, None, v1_plan, sc),
    "bs_fwd s8k lf": lambda: bs.bs_fwd(q8, k8, v8, None, None, lf_plan, sc),
}
if sys.argv[3] == "bwd":
    # each forward call's backward pair, fed its lse and delta: forward
    # call -> (dq, dk/dv, operands, the rest of the arguments, keywords)
    pairs = {
        "masked_flash_fwd causal": (mf.masked_flash_dq, mf.masked_flash_dkv,
                                    (q, k, v, do), (causal, sc), {}),
        "masked_flash_fwd kpm S128": (
            mf.masked_flash_dq, mf.masked_flash_dkv, (qb, kb, vb, dob),
            (dense_b, sc), {"key_mask": kpm_b}),
        "masked_flash_fwd band walk128": (
            mf.masked_flash_dq, mf.masked_flash_dkv, (qs, ks, vs, dos),
            (band, sc), {"key_mask": kpm_s}),
        "flash_fwd causal": (fl.flash_dq, fl.flash_dkv, (q, k, v, do),
                             (True, sc), {}),
        "blocksparse_v2_fwd": (v2.blocksparse_v2_dq, v2.blocksparse_v2_dkv,
                               (qs, ks, vs, dos),
                               (kpm_s, tiles, v2_plan, sc), {}),
        "bs_fwd am kpm": (bs.bs_dq, bs.bs_dkv, (qs, ks, vs, dos),
                          (kpm_s, am, v1_plan, sc), {}),
        "bs_fwd kpm": (bs.bs_dq, bs.bs_dkv, (qs, ks, vs, dos),
                       (kpm_s, None, v1_plan, sc), {}),
        "bs_fwd s8k lf": (bs.bs_dq, bs.bs_dkv, (q8, k8, v8, do8),
                          (None, None, lf_plan, sc), {})}
    bwd = {}
    for name, (dq, dkv, (qq, kk, vv, dd), rest, kw) in pairs.items():
        o, lse = calls[name]()
        delta = (dd.float() * o.float()).sum(-1)
        args = (qq, kk, vv, dd, lse, delta, *rest)
        for fn, part in ((dq, "_dq"), (dkv, "_dkv")):
            bwd[name.replace("_fwd", part)] = \
                lambda fn=fn, args=args, kw=kw: fn(*args, **kw)
    calls = bwd
out = {"package": deepspeed_tpu_torch.__file__}
for name, fn in calls.items():
    out[name] = c.time_ms(fn, c.TIMED_CALLS, flush)
print(json.dumps(out), flush=True)
'''


def time_both(old_root: str, rounds: int = 1, bodies: str = "fwd") -> int:
    repo = os.getcwd()
    roots = {"old": os.path.abspath(old_root), "new": repo}
    _build_both(old_root, SOURCES)
    runs = []
    for tree in ("old", "new", "new", "old") * rounds:
        res = subprocess.run([sys.executable, "-c", _WORKER, roots[tree],
                              repo, bodies], check=True, capture_output=True,
                             text=True)
        row = json.loads(res.stdout.strip().splitlines()[-1])
        if not row.pop("package").startswith(roots[tree]):
            raise RuntimeError(f"the {tree} run imported another package")
        runs.append((tree, row))
    for name in runs[0][1]:
        ms = {t: [r[name] for tt, r in runs if tt == t] for t in roots}
        print(json.dumps({"kernel": name, "ms_old": ms["old"],
                          "ms_new": ms["new"],
                          "new_over_old": sum(ms["new"]) / sum(ms["old"])}),
              flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("sass", help="compare the SASS function by function")
    a.add_argument("sources", nargs="*", default=list(SOURCES),
                   help="source names, e.g. flash.cu")
    a.add_argument("--show", type=int, default=0,
                   help="print this many lines of the first differing "
                        "function's instruction diff")
    t = sub.add_parser("time", help="time the kernels of a body in turns")
    t.add_argument("--rounds", type=int, default=1,
                   help="rounds of four turns (parent, change, change, "
                        "parent)")
    t.add_argument("--bodies", choices=("fwd", "bwd"), default="fwd",
                   help="the kernels on the forward body, or on the dq "
                        "and dk/dv bodies")
    ap.add_argument("--old", required=True,
                    help="the directory holding the reference's package")
    args = ap.parse_args(argv)
    if args.cmd == "sass":
        return sass(args.old, args.sources or SOURCES, args.show)
    return time_both(args.old, args.rounds, args.bodies)


if __name__ == "__main__":
    sys.exit(main())
