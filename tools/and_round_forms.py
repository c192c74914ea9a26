#!/usr/bin/env python3
"""Time the AND round's two kernels against their earlier forms and probes
on one NVIDIA GPU, on calls captured from real batches.

The AND round is kernel B1 (``intersect_rounds.segmented_decode_and``:
decode a packed gap tile, prefix-sum it, probe the query's candidate
bitmap) and B2's bits form (``accumulate.scatter_bits``: OR the survivors
into the new bitmap).  ``tools/and_round_forms.cu`` keeps the forms the port
had before (B1 a block per entry; B2 bits a thread per lane from a flat
index) and probes of them, built with ``cuda_build``'s nvcc and flags:

  B1    port; (a) the earlier form as it is; (b) every probe reading one
        fixed word (decode, scan and stores); (c) no stores (loads, decode
        and probes).
  B2    port (4 lanes' mask a thread, merges a warp's lanes per word; in
        the fused round it reads B1's int32 hit words); flat (the earlier
        form); block (256 lanes of one entry a block, one atomicOr a live
        lane); block_merged (the same, merged per word); warp128_serial
        (the port's first form: its four sub-rounds in series); (b) every
        lane dead (the mask read alone), through the port and the flat
        form; in the fused round also the ``hits != 0`` pass the port no
        longer makes, and the merged forms on the hit words.

Inputs: GOV2's statistics (``synth.make_corpus("gov2")``, 25,205,179 docs,
fused placement), one batch of 256 AND queries and one of 256
``and_scored`` queries (k = 10), drawn as ``chip_smoke.py`` draws them,
with the largest B1 call of each bit width and the largest B2 bits call of
each round kind (seed, fused, probed plain where one ran) kept from each;
then the same shapes with synthetic inputs (random tile words and bitmap;
survivors of every second lane, ids evenly spaced).  Every form's output is
checked equal to the port's.  Prints one line a case (each form's least
and largest of two medians, each the median CUDA-event ms of 10 calls
queued behind a spin of the card, with the counts and sector floor), the
card's name and power limit, and a JSON line.  Usage::

    python3 tools/and_round_forms.py [--n-docs 25205179] [--seed 0]
                                     [--out FILE]

``chip_smoke.py`` imports :func:`build`, the form launchers, the capture
and the counts from here to time the earlier forms beside the port's
kernels on its own captures.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA data sheet
RUNS = 10
SPIN_CYCLES = 2_000_000         # about 1 ms of the card's clock
QUERIES, QUERY_TERMS, K = 256, 120, 10
B1_PROBES = {"a_as_is": 0, "b_fixed_probe_word": 1, "c_no_stores": 2}
BITS_FORMS = {"flat": 0, "block": 1, "block_merged": 2,
              "warp128_serial": 3}


def build():
    """Compile ``tools/and_round_forms.cu`` with the port's nvcc and flags
    into ``build/and_round_forms/``; returns the loaded library."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import cuda_build
    out = os.path.join(ROOT, "build", "and_round_forms")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, f"and_round_forms.{os.getpid()}.so")
    proc = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                           so, os.path.join(ROOT, "tools",
                                            "and_round_forms.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    lib.forms_b1_block.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                                   + [ctypes.c_longlong, ctypes.c_int]
                                   + [ctypes.c_longlong] * 3
                                   + [ctypes.c_void_p])
    lib.forms_bits.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                               + [ctypes.c_longlong] * 4
                               + [ctypes.c_int, ctypes.c_void_p])
    lib.forms_b1_block.restype = lib.forms_bits.restype = ctypes.c_int
    return lib


def _stream(torch):
    return torch.cuda.current_stream().cuda_stream


def b1_block(lib, probe: int, tiles, slots, qslots, firsts, ns, cand,
             bw: int, crows: int, out=None):
    """B1's earlier form (a block per entry), probe 0, 1 or 2; returns
    (ids, hits), into ``out`` where given."""
    import torch
    from repro_torch.kernels.decode_fused import rows_per_block
    w = slots.shape[0]
    if out is None:
        ids = torch.empty((w * 4, 128), dtype=torch.int32,
                          device=tiles.device)
        out = ids, torch.empty_like(ids)
    ids, hits = out
    err = lib.forms_b1_block(
        probe, tiles.data_ptr(), slots.data_ptr(),
        None if qslots is None else qslots.data_ptr(), firsts.data_ptr(),
        ns.data_ptr(), cand.data_ptr(), ids.data_ptr(), hits.data_ptr(), w,
        bw, tiles.shape[0] // rows_per_block(bw), cand.shape[0] // crows,
        crows * 128, _stream(torch))
    if err:
        raise RuntimeError(f"forms_b1_block(probe={probe}): CUDA error {err}")
    return ids, hits


def bits_form(lib, form: str, bm, ids, qslot, surv):
    """B2 bits in one of the comparison forms (``form`` a key of
    BITS_FORMS) on a bool mask or, "block_merged" and "warp128_serial",
    int32 hit words, in place; returns ``bm``."""
    import torch
    err = lib.forms_bits(BITS_FORMS[form], bm.data_ptr(), ids.data_ptr(),
                         qslot.data_ptr(), surv.data_ptr(), ids.shape[0],
                         ids.shape[1], bm.shape[0], bm.shape[1],
                         surv.element_size(), _stream(torch))
    if err:
        raise RuntimeError(f"forms_bits({form}): CUDA error {err}")
    return bm


# --------------------------------------------------------------------------- #
# counts: what a call must move
# --------------------------------------------------------------------------- #


def b1_counts(slots, qslots, ns, d, bw: int, crows: int) -> dict:
    """What a B1 call needs, from its inputs and its docids ``d`` (W, 512):
    distinct tile rows, live lanes, distinct probed words and 32-byte
    sectors (every lane probes, the lanes past ``ns`` the last docid's
    word); its bound (tile rows, 12-16 B of indices an entry, 4 B a probed
    word, 4 KB of outputs an entry) and its sector floor (32 B a probed
    sector in place of 4 B a word)."""
    import torch
    from repro_torch.kernels.decode_fused import rows_per_block
    w = slots.shape[0]
    cw = crows * 128
    q = (qslots.long() if qslots is not None
         else torch.zeros(w, dtype=torch.long, device=d.device))
    word = torch.clamp((d.long() & 0xFFFFFFFF) >> 5, max=cw - 1)
    probed = torch.unique(q[:, None] * cw + word)
    rows = torch.unique(slots).numel() * rows_per_block(bw)
    fixed = rows * 512 + w * (16 if qslots is not None else 12) + w * 4096
    c = {"entries": w, "tile_rows": rows, "live_lanes": int(ns.long().sum()),
         "probed_words": probed.numel(),
         "probed_sectors": torch.unique_consecutive(probed >> 3).numel()}
    c["bytes"] = fixed + 4 * c["probed_words"]
    c["floor_bytes"] = fixed + 32 * c["probed_sectors"]
    return c


def bits_counts(q_rows: int, words: int, ids, qslot, surv,
                mask_bytes: int) -> dict:
    """What a B2 bits call needs: live lanes, distinct touched words and
    32-byte sectors, and distinct (query, word) pairs per warp of 32 lanes
    of one entry (the atomics after the warp merge); its bound (the mask as
    read, the id of each live lane, 4 B of qslot an entry, 8 B a touched
    word) and its sector floor (64 B a touched sector)."""
    import torch
    p, lanes = ids.shape
    live = surv != 0
    q = qslot.long()[:, None].expand(p, lanes)
    flat = (q * words + ((ids.long() & 0xFFFFFFFF) >> 5))[live]
    warp = (torch.arange(p, device=ids.device)[:, None] * (-(-lanes // 32))
            + torch.arange(lanes, device=ids.device)[None, :] // 32)[live]
    touched = torch.unique(flat)
    n_live = int(live.sum())
    inputs = p * lanes * mask_bytes + n_live * 4 + p * 4
    c = {"entries": p, "lanes": lanes, "live_lanes": n_live,
         "touched_words": touched.numel(),
         "touched_sectors": torch.unique_consecutive(touched >> 3).numel(),
         "warp_words": torch.unique(warp * (q_rows * words)
                                    + flat).numel()}
    c["bytes"] = inputs + 8 * c["touched_words"]
    c["floor_bytes"] = inputs + 64 * c["touched_sectors"]
    return c


def ms_of(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# --------------------------------------------------------------------------- #
# capture of real calls
# --------------------------------------------------------------------------- #


def _keep(store: dict, size: int, values: dict) -> None:
    """Replace ``store`` with host copies of ``values`` if ``size`` is the
    largest offered so far."""
    if size > store.get("size", -1):
        store.clear()
        store["size"] = size
        store.update({k: v.cpu() if hasattr(v, "cpu") else v
                      for k, v in values.items()})


@contextlib.contextmanager
def capture_and_rounds(intersect_rounds, accumulate, store: dict):
    """While open, keeps host copies of the largest B1 call of each bit
    width (``store["B1"][bw]``: tiles, slots, qslots, firsts, ns, cand,
    crows) and the largest B2 bits call of each AND round kind
    (``store["B2"][kind]``: ids, qslot, surv, Q, words; kind "seed" for
    ``round_accumulate(probe=False)``, "probed" for a probed plain round,
    "fused" for ``round_accumulate_masked``, whose surv is B1's int32 hit
    words).  B2 bits calls outside an AND round (the ranked rounds'
    membership scatter) are not kept."""
    store.setdefault("B1", {})
    store.setdefault("B2", {})
    kind = []
    saved = {(m, n): getattr(m, n) for m, n in (
        (intersect_rounds, "segmented_decode_and"),
        (intersect_rounds, "round_accumulate"),
        (intersect_rounds, "round_accumulate_masked"),
        (accumulate, "scatter_bits"))}

    def decode(tiles, slots, qslots, firsts, ns, cand_tiles, bw, crows):
        _keep(store["B1"].setdefault(bw, {}), slots.shape[0],
              {"tiles": tiles, "slots": slots, "qslots": qslots,
               "firsts": firsts, "ns": ns, "cand": cand_tiles,
               "crows": crows})
        return saved[intersect_rounds, "segmented_decode_and"](
            tiles, slots, qslots, firsts, ns, cand_tiles, bw=bw, crows=crows)

    def in_kind(name, which):
        def hook(*args, **kwargs):
            kind.append(which(kwargs))
            try:
                return saved[intersect_rounds, name](*args, **kwargs)
            finally:
                kind.pop()
        return hook

    def bits(bm, ids, qslot, surv):
        if kind:
            _keep(store["B2"].setdefault(kind[-1], {}), ids.shape[0],
                  {"ids": ids, "qslot": qslot, "surv": surv,
                   "Q": bm.shape[0], "words": bm.shape[1]})
        return saved[accumulate, "scatter_bits"](bm, ids, qslot, surv)

    intersect_rounds.segmented_decode_and = decode
    intersect_rounds.round_accumulate = in_kind(
        "round_accumulate",
        lambda kw: "probed" if kw.get("probe", True) else "seed")
    intersect_rounds.round_accumulate_masked = in_kind(
        "round_accumulate_masked", lambda kw: "fused")
    accumulate.scatter_bits = bits
    try:
        yield store
    finally:
        for (m, n), f in saved.items():
            setattr(m, n, f)


def check_captures(store: dict, what: str) -> None:
    """An AND batch runs B1 and the seed and fused rounds' B2 bits: raise if
    one of those captures is empty (the hook fell off the call path)."""
    missing = [k for k, v in (("B1", store["B1"]),
                              ("B2 seed", store["B2"].get("seed")),
                              ("B2 fused", store["B2"].get("fused"))) if not v]
    if missing:
        raise AssertionError(f"{what}: no {', '.join(missing)} call captured")


# --------------------------------------------------------------------------- #
# the timing tool
# --------------------------------------------------------------------------- #


def median_ms(fn, torch) -> float:
    """Median CUDA-event ms of RUNS calls of ``fn`` after two warm-ups, each
    queued behind a spin of the card."""
    fn()
    fn()
    times = []
    for _ in range(RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[RUNS // 2]


def in_turns(forms: dict, torch) -> dict:
    """{name: [two medians]}: each form timed twice, in turn, forwards then
    backwards."""
    got = {}
    names = list(forms)
    for name in names + names[::-1]:
        got.setdefault(name, []).append(median_ms(forms[name], torch))
    return {n: sorted(v) for n, v in got.items()}


def _fmt(times: dict) -> str:
    return "  ".join(f"{n} {min(v):.4f}/{max(v):.4f}" for n, v in times.items())


def b1_case(lib, label, a, bw, crows, torch):
    """Time B1's forms on one call's inputs ``a`` (tiles, slots, qslots,
    firsts, ns, cand); checks the earlier form equal to the port's."""
    from repro_torch.kernels import intersect_rounds
    want = intersect_rounds.segmented_decode_and(*a, bw=bw, crows=crows)
    old = b1_block(lib, 0, *a, bw, crows)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(want, old)):
        raise AssertionError(f"B1 {label}: the earlier form differs")
    counts = b1_counts(a[1], a[2], a[4], want[0].view(-1, 512), bw, crows)
    out = (torch.empty_like(want[0]), torch.empty_like(want[1]))
    del want
    forms = {"port": lambda: intersect_rounds.segmented_decode_and(
        *a, bw=bw, crows=crows)}
    forms.update({p: (lambda k=k: b1_block(lib, k, *a, bw, crows, out))
                  for p, k in B1_PROBES.items()})
    times = in_turns(forms, torch)
    print(f"B1 {label} bw={bw} W={a[1].shape[0]}: {_fmt(times)}; bound "
          f"{ms_of(counts['bytes']):.4f} floor "
          f"{ms_of(counts['floor_bytes']):.4f} ms; {counts}", flush=True)
    return {"bw": bw, "ms": times, "counts": counts,
            "bound_ms": ms_of(counts["bytes"]),
            "floor_ms": ms_of(counts["floor_bytes"])}


def bits_case(lib, label, q, words, ids, qslot, surv, torch):
    """Time B2 bits' forms on one call's inputs; ``surv`` is bool or, in the
    fused round, B1's int32 hit words.  Checks every form's bitmap equal to
    the port's on a zeroed bitmap."""
    from repro_torch.kernels import accumulate
    dev = ids.device
    bm = torch.zeros((q, words), dtype=torch.int32, device=dev)
    alive = surv != 0
    dead = torch.zeros_like(alive)
    want = accumulate.scatter_bits(bm.clone(), ids, qslot, surv)
    for form in BITS_FORMS:
        got = bits_form(lib, form, bm.clone(), ids, qslot, alive)
        if not torch.equal(got, want):
            raise AssertionError(f"B2 bits {label}: form {form} differs")
    del got, want
    counts = bits_counts(q, words, ids, qslot, surv, surv.element_size())
    forms = {f: (lambda f=f: bits_form(lib, f, bm, ids, qslot, alive))
             for f in BITS_FORMS}
    forms["b_dead_flat"] = lambda: bits_form(lib, "flat", bm, ids, qslot,
                                             dead)
    forms["port"] = lambda: accumulate.scatter_bits(bm, ids, qslot, surv)
    forms["b_dead_port"] = lambda: accumulate.scatter_bits(bm, ids, qslot,
                                                           dead)
    if surv.dtype != torch.bool:
        forms["block_merged_hits"] = lambda: bits_form(
            lib, "block_merged", bm, ids, qslot, surv)
        forms["warp128_serial_hits"] = lambda: bits_form(
            lib, "warp128_serial", bm, ids, qslot, surv)
        forms["pass_then_flat"] = lambda: bits_form(lib, "flat", bm, ids,
                                                    qslot, surv != 0)
        forms["pass"] = lambda: surv != 0
    times = in_turns(forms, torch)
    print(f"B2 bits {label} P={ids.shape[0]} L={ids.shape[1]}: "
          f"{_fmt(times)}; bound {ms_of(counts['bytes']):.4f} floor "
          f"{ms_of(counts['floor_bytes']):.4f} ms; {counts}", flush=True)
    return {"ms": times, "counts": counts, "bound_ms": ms_of(counts["bytes"]),
            "floor_ms": ms_of(counts["floor_bytes"])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-docs", type=int, default=25_205_179)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the JSON result to this file")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import gc

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this tool times kernels on the card")
        return 2
    from repro_torch.data import synth
    from repro_torch.index.engine import QueryBatch, QueryEngine
    from repro_torch.index.invindex import InvertedIndex
    from repro_torch.kernels import accumulate, cuda_build, intersect_rounds

    cuda_build.build()
    lib = build()
    dev = torch.device("cuda", 0)
    doclen, postings = synth.make_corpus("gov2", seed=args.seed,
                                         n_docs=args.n_docs)
    eng = QueryEngine(InvertedIndex.build(doclen, postings),
                      cache_blocks=1 << 22).to_device(fused=True)
    terms = sorted(postings)
    del doclen, postings
    captured = {}
    for mode, seed in (("and", args.seed + 3), ("and_scored", args.seed + 5)):
        rng = np.random.default_rng(seed)
        qs = [rng.choice(terms[:QUERY_TERMS], size=rng.integers(2, 4),
                         replace=False).tolist() for _ in range(QUERIES)]
        with capture_and_rounds(intersect_rounds, accumulate,
                                captured.setdefault(mode, {})):
            eng.execute(eng.plan(QueryBatch(qs, mode=mode, k=K)))
        check_captures(captured[mode], mode)
        print(f"{mode}: captured B1 at bw {sorted(captured[mode]['B1'])}, "
              f"B2 bits kinds {sorted(captured[mode]['B2'])}", flush=True)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def rand_words(shape):
        return torch.randint(-2**31, 2**31, shape, generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

    result = {"B1": {}, "B2": {}}
    for mode, store in captured.items():
        for bw, cap in sorted(store["B1"].items()):
            a = [None if cap[k] is None else cap[k].to(dev) for k in
                 ("tiles", "slots", "qslots", "firsts", "ns", "cand")]
            result["B1"][f"{mode} bw {bw}"] = b1_case(
                lib, f"captured {mode}", a, bw, cap["crows"], torch)
            # synthetic at the same shape: random tile words and bitmap
            a[0], a[5] = rand_words(a[0].shape), rand_words(a[5].shape)
            result["B1"][f"{mode} bw {bw} synthetic"] = b1_case(
                lib, f"synthetic {mode}", a, bw, cap["crows"], torch)
            del a
        for kind, cap in sorted(store["B2"].items()):
            ids, qslot, surv = (cap[k].to(dev) for k in ("ids", "qslot",
                                                          "surv"))
            result["B2"][f"{mode} {kind}"] = bits_case(
                lib, f"captured {mode} {kind}", cap["Q"], cap["words"], ids,
                qslot, surv, torch)
            # synthetic at the same shape: ids evenly spaced over each
            # query's row, every second lane alive
            p, lanes = ids.shape
            qslot = torch.sort(qslot).values
            rank = (torch.arange(p, device=dev)
                    - torch.searchsorted(qslot, qslot))
            n_max = int(torch.bincount(qslot.long()).max())
            step = max(1, cap["words"] * 32 // (n_max * lanes))
            ids = ((rank[:, None] * lanes + torch.arange(lanes, device=dev))
                   * step).to(torch.int32)
            surv = (torch.arange(lanes, device=dev) % 2 == 0).expand(
                p, lanes).contiguous()
            result["B2"][f"{mode} {kind} synthetic"] = bits_case(
                lib, f"synthetic {mode} {kind} (step {step})", cap["Q"],
                cap["words"], ids, qslot, surv, torch)
            del ids, qslot, surv
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    line = json.dumps({"n_docs": args.n_docs, "card": smi, **result})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
