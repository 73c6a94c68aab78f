"""The kernel-study helpers that chip_smoke.py and
tools/profile_torch_iteration.py share: readers of a kernel library's
SASS (`cuobjdump -sass`: instruction mixes of a loop, a band, an issue
floor), the warp efficiency of per-cell work, the copy of
csrc/chemistry.cu with clock64() stamps that counts each cell's
iterations and sub-steps and the cycles per part, and the C entries of
an earlier build's chemistry and photon-loss libraries (commit 8446144),
timed in turns with this build's.  It imports neither of those two
files, and builds or launches nothing when it is imported.
"""

import heapq
import math
import os
import re
import subprocess
from pathlib import Path

import torch


_SASS_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)([^;]*);")


def _sass_ins(listing):
    """The instructions of one function of a `cuobjdump -sass` listing:
    (address, predicated, opcode, branch target or None, mnemonic with
    its modifiers, e.g. MUFU.EX2)."""
    ins = []
    for m in _SASS_INS.finditer(listing):
        op = m.group(3)
        t = re.search(r"0x([0-9a-f]+)", m.group(5)) if op == "BRA" else None
        ins.append((int(m.group(1), 16), m.group(2) is not None, op,
                    int(t.group(1), 16) if t else None,
                    op + m.group(4)))
    return ins


def _sass_blocks(listing):
    """(basic blocks as (first, end) instruction indices, successors) of
    one function of a `cuobjdump -sass` listing.  Calls (the slow paths
    of division and the like) fall through: their callees are reached
    only through them and so count for nothing."""
    ins = _sass_ins(listing)
    at = {a: i for i, (a, _, _, _, _) in enumerate(ins)}
    lead = {0}
    for i, (_, _, op, t, _) in enumerate(ins):
        if op in ("BRA", "EXIT", "RET"):
            lead.add(i + 1)
            if op == "BRA":
                lead.add(at[t])
    lead = sorted(x for x in lead if x < len(ins))
    ends = lead[1:] + [len(ins)]
    block_of = {s: k for k, s in enumerate(lead)}
    succ = []
    for s, e in zip(lead, ends):
        _, pred, op, t, _ = ins[e - 1]
        nxt = [block_of[e]] if e < len(ins) else []
        if op == "BRA":
            succ.append([block_of[at[t]]] + (nxt if pred else []))
        else:
            succ.append(nxt if pred or op not in ("EXIT", "RET") else [])
    return list(zip(lead, ends)), succ


def _sass_loops(succ):
    """The natural loops of a control-flow graph given by its successor
    lists (block 0 the entry): ({header: set of body blocks}, back edges
    as (source, header))."""
    n = len(succ)
    preds = [[] for _ in range(n)]
    for k in range(n):
        for j in succ[k]:
            preds[j].append(k)
    # dominators (Cooper, Harvey and Kennedy) over reverse postorder
    post, seen, stack = [], {0}, [(0, iter(succ[0]))]
    while stack:
        v, it = stack[-1]
        w = next((w for w in it if w not in seen), None)
        if w is None:
            post.append(stack.pop()[0])
        else:
            seen.add(w)
            stack.append((w, iter(succ[w])))
    rank = {v: i for i, v in enumerate(reversed(post))}
    idom = {0: 0}
    changed = True
    while changed:
        changed = False
        for v in reversed(post[:-1]):
            ps = [p for p in preds[v] if p in idom]
            d = ps[0]
            for p in ps[1:]:
                while d != p:
                    while rank[d] > rank[p]:
                        d = idom[d]
                    while rank[p] > rank[d]:
                        p = idom[p]
            if idom.get(v) != d:
                idom[v], changed = d, True

    def dominates(h, v):
        while v != h and v != 0:
            v = idom[v]
        return v == h

    back = {(s, h) for s in seen for h in succ[s] if dominates(h, s)}
    loops = {}
    for s, h in back:
        body, todo = loops.setdefault(h, {h}), [s]
        while todo:
            v = todo.pop()
            if v not in body:
                body.add(v)
                todo.extend(preds[v])
    return loops, back


# float32-pipe opcodes (adds, multiplies, FMAs, min/max, compares,
# selects, the division's range check)
FP32_OPS = frozenset(("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL",
                      "FSET", "FCHK", "FRND", "FADD32I", "FMUL32I",
                      "FFMA32I", "FSWZADD"))


def sass_band_mix(listing, n_ex2):
    """The instruction mix of one pass through the band loop of a sweep
    kernel's SASS `listing`: {"ex2": MUFU.EX2, "fp32": float32-pipe
    instructions (FP32_OPS), "rcp": MUFU.RCP (one per IEEE division or
    reciprocal), "expf_reduction": FFMA.SAT and FFMA.RM (expf's range
    reduction), "total": all instructions} on the path from the loop's
    header back to it with the most MUFU.EX2 and, among those, the fewest
    calls (a division's slow path, rarely taken) and instructions: with
    the node loop unrolled, the path of a thick band (2K MUFU.EX2; a thin
    band skips e_out).  The loop is the innermost one whose blocks hold at
    least n_ex2 MUFU.EX2 (2K for a K-node band); a loop inside it counts
    once.  For a build whose node loop ran over a runtime K, n_ex2 = 2
    finds the node loop's pass instead."""
    ins = _sass_ins(listing)
    blocks, succ = _sass_blocks(listing)
    loops, back = _sass_loops(succ)
    held = [h for h in loops
            if _ins_mix(ins, blocks, loops[h])["ex2"] >= n_ex2]
    if not held:
        raise ValueError(f"no loop holds {n_ex2} MUFU.EX2")
    h = min(held, key=lambda g: len(loops[g]))
    out = _best_path(ins, blocks, succ, back, h,
                     [s for s, g in back if g == h], loops[h], "ex2")[1]
    return {k: out[k] for k in ("ex2", "fp32", "rcp", "expf_reduction",
                                "total")}


def sass_issue_floor(listing):
    """One warp's issue floor of one fixed-point iteration: the fewest
    instructions on a path through the fixed-point loop's body, from its
    header to a branch back to it, in the SASS `listing` of one
    evolve1d_kernel.  The loop is the largest natural loop inside the
    march over the shells (the largest loop); inner loops count once,
    rarely taken branches not at all.  A warp issues at most one
    instruction per cycle, so an iteration takes at least this many."""
    blocks, succ = _sass_blocks(listing)
    loops, back = _sass_loops(succ)
    size = lambda v: blocks[v][1] - blocks[v][0]
    (march, outer), *inner = sorted(
        loops.items(), key=lambda kv: -sum(size(v) for v in kv[1]))
    h, body = next((h, b) for h, b in inner if h != march and b <= outer)
    dist, heap = {h: size(h)}, [(size(h), h)]
    while heap:
        d, v = heapq.heappop(heap)
        if d > dist[v]:
            continue
        for w in succ[v]:
            if w in body and (v, w) not in back and d + size(w) < dist.get(
                    w, math.inf):
                dist[w] = d + size(w)
                heapq.heappush(heap, (dist[w], w))
    return min(dist[s] for s, hh in back if hh == h and s in dist)


# the pipes a chemistry bound counts beside the issue: float64
# arithmetic (64 lanes per SM and clock on the H100 SXM) and the
# special-function units (16)
FP64_OPS = frozenset(("DADD", "DMUL", "DFMA", "DSETP", "DMNMX"))
MIX_KEYS = ("total", "fp32", "fp64", "mufu", "ex2", "lg2", "rcp",
            "expf_reduction", "lds", "ldc", "uldc", "ldg", "stg", "fchk",
            "calls")


def _ins_mix(ins, blocks, path):
    """The instruction mix (MIX_KEYS) of the blocks on `path`."""
    out = dict.fromkeys(MIX_KEYS, 0)
    for v in path:
        for _, _, op, _, mn in ins[blocks[v][0]:blocks[v][1]]:
            out["total"] += 1
            out["calls"] += op == "CALL"
            out["fp32"] += op in FP32_OPS
            out["fp64"] += op in FP64_OPS
            out["mufu"] += op == "MUFU"
            out["ex2"] += mn.startswith("MUFU.EX2")
            out["lg2"] += mn.startswith("MUFU.LG2")
            out["rcp"] += mn.startswith("MUFU.RCP")
            out["expf_reduction"] += mn.startswith(("FFMA.SAT", "FFMA.RM"))
            out["lds"] += op == "LDS"
            out["ldc"] += op == "LDC"
            out["uldc"] += op == "ULDC"
            out["ldg"] += op == "LDG"
            out["stg"] += op == "STG"
            out["fchk"] += op == "FCHK"
    return out


def _best_path(ins, blocks, succ, back, start, ends, within, key):
    """The path of blocks from `start` to a block of `ends` over the
    edges inside `within` that are not back edges (an inner loop's body
    once) with the most `key` instructions and, among those, the fewest
    calls (a division's slow path) and instructions.  Returns (path,
    mix)."""
    nxt = {v: [w for w in succ[v] if w in within and (v, w) not in back]
           for v in within}
    # postorder of the acyclic part
    order, seen, stack = [], {start}, [(start, iter(nxt[start]))]
    while stack:
        v, it = stack[-1]
        w = next((w for w in it if w not in seen), None)
        if w is None:
            order.append(stack.pop()[0])
        else:
            seen.add(w)
            stack.append((w, iter(nxt[w])))
    mixes = {v: _ins_mix(ins, blocks, [v]) for v in seen}
    rank = lambda m: (m[key], -m["calls"], -m["total"])
    best = {start: ([start], mixes[start])}
    for v in reversed(order):
        if v not in best:
            continue
        for w in nxt[v]:
            cand = {k: best[v][1][k] + mixes[w][k] for k in MIX_KEYS}
            if w not in best or rank(cand) > rank(best[w][1]):
                best[w] = (best[v][0] + [w], cand)
    got = [best[e] for e in ends if e in best]
    if not got:
        raise ValueError("no path to the given ends")
    return max(got, key=lambda pm: rank(pm[1]))


def sass_loop_mix(listing, key, inner_key=None):
    """The instruction mixes of a per-cell fixed-point kernel's SASS
    `listing`: {"loop": one pass through the innermost loop whose body
    holds a `key` instruction (e.g. "ex2": doric's exponentials), on the
    path with the most `key` and the fewest calls and instructions;
    "inner": the same for the innermost loop inside it holding an
    `inner_key` instruction (the thermal sub-step: coolin's log10), or
    None; "whole": the path from the entry to an EXIT through the loop
    once, the rest of a cell's work}.  Inner loops count once in the
    loop that holds them."""
    ins = _sass_ins(listing)
    blocks, succ = _sass_blocks(listing)
    loops, back = _sass_loops(succ)

    def loop_mix(h, k):
        return _best_path(ins, blocks, succ, back, h,
                          [s for s, g in back if g == h], loops[h], k)[1]

    held = [h for h in loops if loop_mix(h, key)[key] > 0]
    if not held:
        raise ValueError(f"no loop holds a {key} instruction")
    h = min(held, key=lambda g: len(loops[g]))
    loop = loop_mix(h, key)
    inner = None
    if inner_key is not None:
        inside = [g for g in loops if g != h and loops[g] < loops[h]
                  and loop_mix(g, inner_key)[inner_key] > 0]
        if inside:
            inner = loop_mix(min(inside, key=lambda x: len(loops[x])),
                             inner_key)
    return {"loop": loop, "inner": inner,
            "whole": _whole_path(ins, blocks, succ, back, key)}


def _whole_path(ins, blocks, succ, back, key):
    """The mix of the path from the entry to an unpredicated EXIT with
    the most `key` instructions (every loop body once)."""
    exits = [v for v, (a, b) in enumerate(blocks)
             if ins[b - 1][2] == "EXIT" and not ins[b - 1][1]]
    return _best_path(ins, blocks, succ, back, 0, exits,
                      set(range(len(blocks))), key)[1]


def sass_per_band(listing):
    """The photon-loss kernel's instruction mix per band and cell: one
    pass through the innermost loop that holds a MUFU.RCP (a band loop
    over a run-time count, unrolled some times) or, with the bands
    unrolled whole, the path from the entry to an EXIT with the most
    MUFU.RCP (the cells' loads and stores counted in), divided by the
    MUFU.RCP on it (one reciprocal per band and cell).  Returns (mix per
    band and cell, reciprocals per pass)."""
    ins = _sass_ins(listing)
    blocks, succ = _sass_blocks(listing)
    loops, back = _sass_loops(succ)
    held = []
    for h, body in loops.items():
        m = _best_path(ins, blocks, succ, back, h,
                       [s for s, g in back if g == h], body, "rcp")[1]
        if m["rcp"]:
            held.append((len(body), m))
    m = (min(held, key=lambda x: x[0])[1] if held
         else _whole_path(ins, blocks, succ, back, "rcp"))
    return {k: v / m["rcp"] for k, v in m.items()}, m["rcp"]


def kernel_sass(path):
    """{mangled function name: its SASS listing} of a kernel library
    (`cuobjdump -sass`)."""
    from c2ray_tpu_torch import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return {fn.split(None, 1)[0]: fn
            for fn in re.split(r"\n\s*Function : ", sass)[1:]}


_ANON = re.compile(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}")
_ADDR = re.compile(r"/\*0*([0-9a-f]+)\*/")
# a sweep source's source-cell kernel before it took the rate route as
# its third template parameter (source_cell_kernel<T, kHeat>), named as
# the fixed rule's instantiation now (source_cell_kernel<T, kHeat, 0>)
_SOURCE_CELL = re.compile(r"(source_cell_kernelI[fd]Lb[01]E)(EEv)")


def comparable_sass(path):
    """kernel_sass of a library in the form two builds compare: the hash
    of the source's path that an anonymous namespace carries dropped
    from names and listings, and each listing's layout -- cuobjdump pads
    its columns to the widest function of the library -- dropped too:
    a line's tokens, blank lines out, addresses without leading zeros;
    an earlier build's source_cell_kernel<T, kHeat> named as the fixed
    rule's source_cell_kernel<T, kHeat, 0> (_SOURCE_CELL).  Instructions,
    operands and encodings stay as they are."""
    def name(text):
        return _SOURCE_CELL.sub(r"\1Li0E\2", _ANON.sub("(anon)", text))

    def key(listing):
        lines = (" ".join(_ADDR.sub(r"/*\1*/", line).split())
                 for line in name(listing).splitlines())
        return "\n".join(line for line in lines if line)
    return {name(k): key(v) for k, v in kernel_sass(path).items()}


def warp_efficiency(work):
    """The share of a warp's lane steps that do work when a warp runs
    until its slowest cell is done: the sum over cells of `work` (per
    cell, in the kernel's cell order; the last warp padded with idle
    lanes) over the sum over warps of 32 x the warp's largest work."""
    w = work.to(torch.float64).reshape(-1)
    w = torch.nn.functional.pad(w, (0, (-w.numel()) % 32)).reshape(-1, 32)
    lanes = 32.0 * float(w.max(dim=1).values.sum())
    return float(w.sum()) / lanes if lanes else 1.0


CHEM_PARTS = ("loads", "fits", "doric", "blend", "thermal", "convergence",
              "stores")

# The stamps of stamp_chemistry: each thread adds up the clock64()
# cycles of each part of its cell's fixed point, from the stamp before
# it to its own (no __syncwarp: the lanes of a warp leave the loop at
# different iterations), and writes its cell's iteration and summed
# thermal sub-step counts; a warp's sums go to g_chem_cycles, each
# block's first and last %globaltimer (ns) to g_chem_block.
_CHEM_DEFS = """
enum ChemPart {
  kChemLoads, kChemFits, kChemDoric, kChemBlend, kChemThermal, kChemConv,
  kChemStores, kChemParts
};
__device__ unsigned long long g_chem_cycles[kChemParts];
__device__ int* g_chem_nit;
__device__ int* g_chem_nsub;
__device__ unsigned long long* g_chem_block;
__device__ __forceinline__ unsigned long long chem_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define CHEM_SPLIT_INIT()                                             \\
  unsigned long long chem_c[kChemParts] = {};                         \\
  int chem_sub = 0;                                                   \\
  if (threadIdx.x == 0) g_chem_block[2 * blockIdx.x] = chem_now();    \\
  long long chem_t = clock64()
#define CHEM_SPLIT(part)                                              \\
  do {                                                                \\
    const long long chem_n = clock64();                               \\
    chem_c[part] += chem_n - chem_t;                                  \\
    chem_t = chem_n;                                                  \\
  } while (0)
#define CHEM_CELL(cell, nit)                                          \\
  do {                                                                \\
    g_chem_nit[cell] = nit;                                           \\
    g_chem_nsub[cell] = chem_sub;                                     \\
    chem_sub = 0;                                                     \\
  } while (0)
#define CHEM_SPLIT_STORE()                                            \\
  for (int q = 0; q < kChemParts; ++q) {                              \\
    unsigned long long v = chem_c[q];                                 \\
    for (int off = 16; off > 0; off >>= 1)                            \\
      v += __shfl_down_sync(0xffffffffu, v, off);                     \\
    if ((threadIdx.x & 31) == 0) atomicAdd(&g_chem_cycles[q], v);     \\
  }                                                                   \\
  __syncthreads();                                                    \\
  if (threadIdx.x == 0) g_chem_block[2 * blockIdx.x + 1] = chem_now()

"""
_CHEM_ENTRY = """
// Point the stamps at the per-cell counts (n ints each) and the per-block
// times (2 per block), and zero the cycle sums; returns a cudaError_t.
extern "C" int chemistry_split_setup(int* nit, int* nsub,
                                     unsigned long long* blocks) {
  unsigned long long zero[c2ray::kChemParts] = {};
  int err = cudaMemcpyToSymbol(c2ray::g_chem_nit, &nit, sizeof(nit));
  if (!err) err = cudaMemcpyToSymbol(c2ray::g_chem_nsub, &nsub, sizeof(nsub));
  if (!err) err = cudaMemcpyToSymbol(c2ray::g_chem_block, &blocks,
                                     sizeof(blocks));
  if (!err) err = cudaMemcpyToSymbol(c2ray::g_chem_cycles, zero, sizeof(zero));
  return err;
}
// The cycle sums per part (ChemPart order) into out[kChemParts].
extern "C" int chemistry_split_read(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, c2ray::g_chem_cycles,
                              sizeof(unsigned long long) * c2ray::kChemParts);
}
"""
# (pattern, stamp), as _SPLIT_AT, in csrc/chemistry.cu: the loop that
# hands a lane its cells ("loads" holds the hand-out, the cell's loads
# and a lane's wait for the rest of its warp), then each part of an
# iteration, the write-back
_CHEM_AT = (
    (r"(?P<at>)// counters\[0\] \+= conv_flag", _CHEM_DEFS),
    (r"bool need = true;[^\n]*\n  Cell<T> c;(?P<at>)",
     "\n  CHEM_SPLIT_INIT();"),
    (r"if \(!work\) continue;(?P<at>)", "\n    CHEM_SPLIT(kChemLoads);"),
    (r"if constexpr \(kHeat\) rates = rate_coefficients\(c\.avg_t\);"
     r"(?P<at>)", "\n      CHEM_SPLIT(kChemFits);"),
    (r"one_m_eps,\s+T\(1\)\);(?P<at>)", "\n      CHEM_SPLIT(kChemDoric);"),
    (r"nw\.old = blend\(nw\.old, c\.ion\.old, damp\);(?P<at>)",
     "\n      CHEM_SPLIT(kChemBlend);"),
    (r"sub_max = max\(sub_max, th\.nsub\);(?P<at>)",
     "\n        chem_sub += th.nsub;"),
    (r"(?P<at>)\n      // _conv_freeze", "\n      CHEM_SPLIT(kChemThermal);"),
    (r"finished = done \|\| c\.nit >= max_iter;(?P<at>)",
     "\n      CHEM_SPLIT(kChemConv);"),
    (r"out\[\(long long\)k \* n \+ i\] = vals\[k\];(?P<at>)",
     "\n      CHEM_SPLIT(kChemStores);\n      CHEM_CELL(i, c.nit);"),
    (r"(?P<at>)\n  changed = __reduce_add_sync",
     "\n  CHEM_SPLIT(kChemLoads);\n  CHEM_SPLIT_STORE();"),
)
# the same for the kernel of commit 8446144 (one thread per cell, the
# isothermal fits once per thread): there "stores" also holds a lane's
# wait for the rest of its warp
_CHEM_AT_8446144 = (
    (r"(?P<at>)// Input rows \(n cells each\)", _CHEM_DEFS),
    (r"int nit = 0, nsub = 0;(?P<at>)", "\n  CHEM_SPLIT_INIT();"),
    (r"(?P<at>)\n      rates = rate_coefficients\(t_iso\);",
     "\n      CHEM_SPLIT(kChemLoads);"),
    (r"rates = rate_coefficients\(t_iso\);(?P<at>)",
     "\n      CHEM_SPLIT(kChemFits);"),
    (r"(?P<at>)\n    while \(nit < max_iter\) \{",
     "\n    CHEM_SPLIT(kChemLoads);"),
    (r"if constexpr \(kHeat\) rates = rate_coefficients\(avg_t\);(?P<at>)",
     "\n      CHEM_SPLIT(kChemFits);"),
    (r"ion, eps, one_m_eps, T\(1\)\);(?P<at>)",
     "\n      CHEM_SPLIT(kChemDoric);"),
    (r"nw\.old = blend\(nw\.old, ion\.old, damp\);(?P<at>)",
     "\n      CHEM_SPLIT(kChemBlend);"),
    (r"nsub = max\(nsub, th\.nsub\);(?P<at>)",
     "\n        chem_sub += th.nsub;"),
    (r"(?P<at>)\n      // _conv_freeze", "\n      CHEM_SPLIT(kChemThermal);"),
    (r"\+\+nit;(?P<at>)\n      if \(done\) break;",
     "\n      CHEM_SPLIT(kChemConv);"),
    (r"out\[\(long long\)k \* n \+ i\] = vals\[k\];(?P<at>)",
     "\n    CHEM_SPLIT(kChemStores);\n    CHEM_CELL(i, nit);"),
    (r"(?P<at>)\n}\n\ntemplate <typename T, bool kHeat>\nint run_chemistry",
     "\n  CHEM_SPLIT_STORE();"),
)
# the parts that the stamps close, in the order of the source, per
# layout and variant (the heating setup of 8446144 has no stamp)
_CHEM_STAMPS = {
    ("this", False): ("loads", "fits", "doric", "blend", "thermal",
                      "convergence", "stores", "loads"),
    ("this", True): ("loads", "fits", "doric", "blend", "thermal",
                     "convergence", "stores", "loads"),
    ("8446144", False): ("loads", "fits", "loads", "fits", "doric", "blend",
                         "thermal", "convergence", "stores"),
    ("8446144", True): ("loads", "fits", "doric", "blend", "thermal",
                        "convergence", "stores")}


def chem_layout(text):
    """"this" for csrc/chemistry.cu as it stands, "8446144" for the
    kernel of that commit (one thread per cell)."""
    return "8446144" if "int nit = 0, nsub = 0;" in text else "this"


def stamp_chemistry(text):
    """A chemistry.cu `text` (this kernel or commit 8446144's) with the
    clock64() stamps of the split per part, the per-cell counts and block
    times, and the entries chemistry_split_setup / chemistry_split_read;
    raises if the kernel no longer has a place that a stamp goes to."""
    places = _CHEM_AT_8446144 if chem_layout(text) == "8446144" else _CHEM_AT
    return _stamp(text, places, "chemistry.cu") + _CHEM_ENTRY


def _stamp(text, places, name):
    for pattern, stamp in places:
        hits = list(re.finditer(pattern, text))
        if len(hits) != 1:
            raise RuntimeError(f"{len(hits)} places for a stamp in "
                               f"{name}: {pattern!r}")
        at = hits[0].start("at")
        text = text[:at] + stamp + text[at:]
    return text


def build_chem_split(key, src):
    """The library of `src`/chemistry.cu (a kernel directory: this
    tree's csrc/ or a parent's) with stamp_chemistry's stamps, built
    under build/chem_split_<key>/: (ctypes handle, layout, threads a
    block)."""
    import ctypes
    import shutil

    from c2ray_tpu_torch import cuda_build

    d = cuda_build.BUILD_DIR.parent / f"chem_split_{key}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src, d)
    text = (d / "chemistry.cu").read_text()
    (d / "chemistry.cu").write_text(stamp_chemistry(text))
    proc = build_oned(d, d / "libchemistry.so", source="chemistry")
    out = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the stamped chemistry.cu:\n{out}")
    block = int(re.search(r"constexpr int kBlock = (\d+);", text).group(1))
    return ctypes.CDLL(str(d / "libchemistry.so")), chem_layout(text), block


def with_library(name, lib, fn):
    """fn() with `lib` standing in for csrc/<name>.cu's build."""
    from c2ray_tpu_torch import cuda_build

    saved = cuda_build._LIBS.get(name)
    cuda_build._LIBS[name] = lib
    try:
        return fn()
    finally:
        if saved is None:
            del cuda_build._LIBS[name]
        else:
            cuda_build._LIBS[name] = saved


def chem_pass_with(lib, layout, chem, state, rates, dt):
    """One chemistry pass through the library `lib` of this tree's
    kernel (through chemistry_pass_cuda) or of commit 8446144's
    (parent_chemistry_pass): the 12 output rows as one (12, n) tensor
    and the 3 counters."""
    from c2ray_tpu_torch.sweep import global_pass as gp

    if layout == "8446144":
        return parent_chemistry_pass(lib, chem, state, rates, dt)
    s, conv, nit, nsub = with_library(
        "chemistry", lib, lambda: gp.chemistry_pass_cuda(chem, state, rates,
                                                         dt))
    return torch.stack([getattr(s, k) for k in OUT_ROWS]), torch.stack(
        [conv, nit, nsub])


# the chemistry pass's 12 output rows, in the kernel's order
OUT_ROWS = ("h_int0", "h_int1", "he_int0", "he_int1", "he_int2", "h_av0",
            "h_av1", "he_av0", "he_av1", "he_av2", "t_inter", "t_av")


def chem_split_run(lib, layout, chem, state, rates, dt):
    """One chemistry pass through a stamped build: (per-cell iterations,
    per-cell thermal sub-steps summed over the iterations, cycles per
    part summed over the threads (CHEM_PARTS order), each block's
    [start, end] %globaltimer ns, the pass's (outputs, counters))."""
    import ctypes

    from c2ray_tpu_torch import cuda_build

    n, dev = state.ndens.shape[0], state.ndens.device
    nit = torch.full((n,), -1, dtype=torch.int32, device=dev)
    nsub = torch.full((n,), -1, dtype=torch.int32, device=dev)
    blocks = torch.zeros((n // 32 + 2, 2), dtype=torch.int64, device=dev)
    lib.chemistry_split_setup.argtypes = [ctypes.c_void_p] * 3
    lib.chemistry_split_setup.restype = ctypes.c_int
    P = cuda_build.ptr
    cuda_build.check(lib.chemistry_split_setup(P(nit), P(nsub), P(blocks)),
                     "chemistry_split_setup")
    out = chem_pass_with(lib, layout, chem, state, rates, dt)
    torch.cuda.synchronize()
    cycles = (ctypes.c_ulonglong * len(CHEM_PARTS))()
    cuda_build.check(lib.chemistry_split_read(cycles), "chemistry_split_read")
    if bool((nit < 0).any()):
        raise AssertionError("the stamped chemistry pass left cells uncounted")
    blocks = blocks[blocks[:, 1] > 0]
    return nit, nsub, list(cycles), blocks, out


def achieved_occupancy(blocks, block_threads, sms=132, warps_per_sm=64):
    """Mean resident warps per SM over the launch, as a share of the
    64 an SM holds: each block's warps from its first to its last
    %globaltimer reading, over the launch's span on all SMs."""
    b = blocks.double()
    span = float(b[:, 1].max() - b[:, 0].min())
    resident = float((b[:, 1] - b[:, 0]).sum()) * block_threads / 32
    return resident / (span * sms * warps_per_sm)


def parent_chemistry_pass(lib, chem, state, rates, dt):
    """One chemistry pass through a parent build's library (commit
    8446144's C entry: the 20 or 22 input rows stacked into one (rows, n)
    tensor, the cooling table stacked on every call)."""
    import ctypes

    from c2ray_tpu_torch import cuda_build
    from c2ray_tpu_torch.cooling import stacked
    from c2ray_tpu_torch.sweep import global_pass as gp

    heat = not chem.isothermal
    dtype, device = state.ndens.dtype, state.ndens.device
    n = state.ndens.shape[0]
    rows = [state.ndens, state.h0, state.h1, state.he0, state.he1, state.he2,
            state.h_av0, state.h_av1, state.he_av0, state.he_av1,
            state.he_av2, state.h_int0, state.h_int1, state.he_int0,
            state.he_int1, state.he_int2, state.t_av,
            rates.phih, rates.phihe0, rates.phihe1]
    if heat:
        rows += [state.t_final, rates.phiheat]
    inp = torch.stack(rows)
    clumping = state.clumping.to(dtype=dtype).reshape(-1).contiguous()
    cool = (stacked(chem.cooling).to(dtype=dtype, device=device).contiguous()
            if heat else inp)
    out = torch.empty((12, n), dtype=dtype, device=device)
    counters = torch.zeros(3, dtype=torch.int32, device=device)
    name = ("chemistry_heat_" if heat else "chemistry_iso_") + (
        "f32" if dtype == torch.float32 else "f64")
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_double] * 4 + [ctypes.c_int] * 2
                   + [ctypes.c_double, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    P = cuda_build.ptr
    cuda_build.check(fn(P(inp), P(clumping), int(clumping.numel() == n),
                        P(cool), P(out), P(counters), n, float(dt),
                        float(chem.isothermal_temperature),
                        float(chem.cosmo_cool_factor), float(chem.epsilon),
                        int(chem.max_iter), int(gp.DAMP_AFTER),
                        float(gp.DAMP_FACTOR), cuda_build.stream_of(inp)),
                     name)
    return out, counters


def histogram(counts):
    """{range: cells} of per-cell counts by powers of two (0, 1, 2-3,
    4-7, ...)."""
    c = counts.long()
    out = {"0": int((c == 0).sum())}
    lo = 1
    while lo <= int(c.max()):
        k = int(((c >= lo) & (c < 2 * lo)).sum())
        if k:
            out[f"{lo}" if lo == 1 else f"{lo}-{2 * lo - 1}"] = k
        lo *= 2
    return out


def chem_split_stats(nit, nsub, cycles, heating):
    """(summary dict, printable lines) of one stamped pass: iteration
    and sub-step sums and histograms, warp efficiency of the cells'
    work in the order the threads took them (iterations, sub-steps, and
    their cycles weighted by the split), cycles per iteration by part,
    per sub-step, per cell, and each part's share."""
    its, subs = int(nit.sum()), int(nsub.sum())
    per = dict(zip(CHEM_PARTS, cycles))
    loop_parts = ("fits", "doric", "blend", "convergence")
    it_cycles = sum(per[p] for p in loop_parts) / its
    sub_cycles = per["thermal"] / subs if subs else 0.0
    eff = {"iterations": warp_efficiency(nit)}
    if heating:
        eff["sub-steps"] = warp_efficiency(nsub)
        eff["cycles"] = warp_efficiency(nit.double() * it_cycles
                                           + nsub.double() * sub_cycles)
    total = sum(cycles)
    lines = [f"iterations summed {its} ({its / nit.numel():.3f} a cell), "
             f"histogram {histogram(nit)}"]
    if heating:
        lines.append(f"thermal sub-steps summed {subs} ({subs / its:.3f} an "
                     f"iteration), per-cell sums {histogram(nsub)}")
    lines.append(f"warp efficiency in cell order {eff}")
    lines.append(
        f"cycles (summed over the threads) per iteration {it_cycles:.0f} ("
        + ", ".join(f"{p} {per[p] / its:.0f}" for p in loop_parts)
        + f"), per thermal sub-step {sub_cycles:.0f}, per cell loads "
        f"{per['loads'] / nit.numel():.0f}, stores "
        f"{per['stores'] / nit.numel():.0f}; shares "
        + ", ".join(f"{p} {c / total:.3f}" for p, c in per.items()))
    return {"iterations": its, "substeps": subs, "warp_efficiency": eff,
            "cycles_per_iteration": it_cycles,
            "cycles_per_substep": sub_cycles,
            "shares": {p: c / total for p, c in per.items()}}, lines


def parent_photon_losses(lib, tables, rates, fields, vos):
    """One redistribution through a parent build's library (commit
    8446144's C entry: the (nb, 6) band table in device memory, the
    three rate grids by pointer and stride)."""
    import ctypes

    from c2ray_tpu_torch import cuda_build
    from c2ray_tpu_torch.sweep import photon_losses as pls

    nd = fields.ndens
    n = nd.shape[0]
    ins = [nd, fields.h_av0, fields.he_av0, fields.he_av1]
    outs = [rates.phih, rates.phihe0, rates.phihe1]
    sig, W = pls.scaled_sigma_and_weights(tables, rates.photon_loss_bands, n,
                                          vos, nd.dtype)
    tab = torch.cat([sig.T, W], dim=1).contiguous()
    name = "photon_losses_" + ("f32" if nd.dtype == torch.float32 else "f64")
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong,
                                            ctypes.c_double]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                              ctypes.c_void_p])
    fn.restype = ctypes.c_int
    P = cuda_build.ptr
    cuda_build.check(fn(*(P(t) for t in ins), P(tab), tab.shape[0], n,
                        float(pls.DENSITY_FLOOR), *(P(t) for t in outs),
                        outs[0].stride(0), cuda_build.stream_of(nd)), name)
    return rates


def build_oned(src, out, source="evolve1d"):
    """Start nvcc on `source`.cu of the kernel directory `src` into the
    library `out`; returns the process."""
    import subprocess

    from c2ray_tpu_torch import cuda_build

    out.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
         str(out), str(src / f"{source}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


# ---- the sweep kernels of commit 91213d1, timed in turns with this build

# this tree's source_sweep._kernel_tables and _route_args, which
# parent_sweeps replaces in the sweep modules for the parent's turn
_THIS = {}


def _this(name):
    from c2ray_tpu_torch.sweep import source_sweep as ss

    return _THIS.get(name) or getattr(ss, name)

def parent_route_tables(cfg, dtype, track=False):
    """The sweep kernels' tables as commit 91213d1's kernels read them:
    on the tau route the TableRoute itself (unpacked (ntypes, 2, rows,
    nb) tables and the heating columns), on "auto" tables the blocks of
    packed_band_blocks; the fixed rule's are this tree's.  Packed once
    per configuration, tables, dtype and heating, as this tree's."""
    from c2ray_tpu_torch.radiation.quadrature import packed_band_blocks
    from c2ray_tpu_torch.radiation.tables import (RadiationTables,
                                                  packed_table_route)
    from c2ray_tpu_torch.sweep import source_sweep as ss

    heat = ss.sweep_heats(cfg)
    flags = (cfg.has_bb, cfg.has_pl, cfg.has_qso)
    # kept in the configuration's cache as this tree's are, so that the
    # two builds in turns differ in their kernels, not in packing
    key = ("91213d1", id(cfg.tables), *flags, heat, dtype)
    hit = cfg.kernel_cache.get(key)
    if hit is not None:
        return hit[1]
    if isinstance(cfg.tables, RadiationTables):
        tr = packed_table_route(cfg.tables, dtype,
                                cfg.tables.sigma_HI.device, heat, *flags)
        kt = ss.KernelTables(tr.rows, tr, ss.ROUTE_TABLE, heat)
    else:
        flat, blocks = packed_band_blocks(cfg.tables, dtype, heat, *flags)
        if len({b[3] for b in blocks}) == 1 or track:
            return _this("_kernel_tables")(cfg, dtype, track)
        kt = ss.KernelTables(flat, blocks, ss.ROUTE_BLOCKS, heat)
    cfg.kernel_cache[key] = (cfg.tables, kt)
    return kt


def parent_route_args(kt):
    """source_sweep._route_args of commit 91213d1: on the tau route the
    unpacked tables' pointers (photo, heat, hbin); the block list and
    the fixed rule's arguments have this tree's form."""
    import ctypes

    import numpy as np

    from c2ray_tpu_torch import cuda_build
    from c2ray_tpu_torch.sweep import source_sweep as ss

    if kt.K != ss.ROUTE_TABLE:
        return _this("_route_args")(kt)
    tr = kt.types
    nheat = tr.heat.shape[-1] if kt.heat else 0
    cols = list(tr.cols) + [0] * (3 - len(tr.cols))
    ints = np.ascontiguousarray(
        [ss.ROUTE_TABLE, kt.packed.numel(), tr.rows.shape[0], nheat,
         len(tr.cols)] + cols + list(tr.live), dtype=np.int32)
    P = cuda_build.ptr
    null = ctypes.c_void_p(None)
    return (0, [0] * 10, ints,
            [ints.ctypes.data_as(ctypes.c_void_p), P(tr.photo),
             null if tr.heat is None else P(tr.heat), P(tr.hbin)])


class parent_sweeps:
    """with parent_sweeps(libs, src=None): this tree's sweep wrappers
    launch the parent build's libraries ({source: ctypes library} of
    pyramid_sweep, shell_sweep, octant_sweep) with the tables and route
    arguments that build reads: commit 91213d1's (parent_route_tables,
    parent_route_args), or this tree's when the parent's kernel
    directory `src` reads the tau tables as band-major records, as this
    tree does (its table_rates.cuh has load_rec: commit e7dcd29 on)."""

    _MODULES = ("source_sweep", "pyramid_sweep", "octant_sweep")

    def __init__(self, libs, src=None):
        self.libs = libs
        self.parent_args = src is None or "load_rec(" not in (
            Path(src) / "table_rates.cuh").read_text()

    def __enter__(self):
        import importlib

        from c2ray_tpu_torch import cuda_build

        from c2ray_tpu_torch.sweep import source_sweep as ss

        _THIS.setdefault("_kernel_tables", ss._kernel_tables)
        _THIS.setdefault("_route_args", ss._route_args)
        self.saved_libs = {n: cuda_build._LIBS.get(n) for n in self.libs}
        cuda_build._LIBS.update(self.libs)
        self.saved = []
        if not self.parent_args:
            return self
        for name in self._MODULES:
            mod = importlib.import_module(f"c2ray_tpu_torch.sweep.{name}")
            self.saved.append((mod, mod._kernel_tables, mod._route_args))
            mod._kernel_tables = parent_route_tables
            mod._route_args = parent_route_args
        return self

    def __exit__(self, *exc):
        from c2ray_tpu_torch import cuda_build

        for mod, kt, ra in self.saved:
            mod._kernel_tables, mod._route_args = kt, ra
        for n, lib in self.saved_libs.items():
            if lib is None:
                cuda_build._LIBS.pop(n, None)
            else:
                cuda_build._LIBS[n] = lib
        return False


# ---- the 1D kernel of commit e7dcd29 on "auto" tables, timed in turns
# with this build

def parent_oned_tables(ctx, dtype, device):
    """The block list of "auto" tables as commit e7dcd29's 1D kernel
    reads it: (flat rows of packed_band_blocks, the list (int32: per
    block its K, band count, first row value, first incoming value),
    (block count, row values, incoming values), cooling table or None);
    each block's incoming side nb x ((5 if heating else 2) + K) values
    after the one before.  Kept in the context's cache as this tree's
    tables are, so that the two builds in turns differ in their kernels,
    not in packing."""
    import torch

    from c2ray_tpu_torch.cooling import stacked
    from c2ray_tpu_torch.radiation.quadrature import packed_band_blocks

    heat = not ctx.isothermal
    flags = (ctx.has_bb, ctx.has_pl, ctx.has_qso)
    key = ("e7dcd29", id(ctx.tables), id(ctx.cooling), heat, *flags, dtype,
           device)
    hit = ctx.kernel_cache.get(key)
    if hit is not None:
        return hit[2]
    flat, blocks = packed_band_blocks(ctx.tables, dtype, heat, *flags)
    ints, off = [], 0
    for _, _, nb, K, row0 in blocks:
        ints += [K, nb, row0, off]
        off += nb * ((5 if heat else 2) + K)
    cool = (stacked(ctx.cooling).to(dtype=dtype, device=device).contiguous()
            if heat else None)
    out = (flat.to(device), torch.tensor(ints, dtype=torch.int32,
                                         device=device),
           (len(blocks), flat.numel(), off), cool)
    ctx.kernel_cache[key] = (ctx.tables, ctx.cooling, out)
    return out


def parent_evolve1d(lib, ctx, state, dt):
    """onedim.evolve.evolve1d_cuda with commit e7dcd29's library `lib`:
    on "auto" tables through that build's entries (the block list of
    parent_oned_tables), on the other tables through this tree's wrapper,
    whose entries that build shares.  Returns (state, nits, counters)."""
    import ctypes

    import torch

    from c2ray_tpu_torch import cuda_build
    from c2ray_tpu_torch.onedim import evolve as ev1

    call = lambda: ev1.evolve1d_cuda(ctx, state, dt)
    kt = ev1._kernel_tables(ctx, state.ndens.dtype, state.ndens.device)
    if kt.route != "auto":
        return with_library("evolve1d", lib, call)
    nd = state.ndens
    dtype, device, mesh = nd.dtype, nd.device, nd.shape[0]
    flat, blist, layout, cool = parent_oned_tables(ctx, dtype, device)
    heat = not ctx.isothermal
    name = ("evolve1d_auto_" + ("heat_" if heat else "iso_")
            + ("f32" if dtype == torch.float32 else "f64"))
    ins = [t.contiguous() for t in (nd, state.temper, state.xh, state.xhe,
                                    ctx.vol)]
    xh_out = torch.empty((mesh, 2), dtype=dtype, device=device)
    xhe_out = torch.empty((mesh, 3), dtype=dtype, device=device)
    temper_out = torch.empty(mesh, dtype=dtype, device=device)
    nits = torch.empty(mesh, dtype=torch.int32, device=device)
    counters = torch.zeros(4, dtype=torch.int32, device=device)
    P = lambda t: (ctypes.c_void_p(None) if t is None
                   else cuda_build.ptr(t))
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                   + [ctypes.c_double] * 11 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(*(P(t) for t in ins), P(flat), P(blist), P(cool), P(xh_out),
             P(xhe_out), P(temper_out), P(nits), P(counters), mesh, *layout,
             int(ctx.max_cell_iter), float(ctx.dr), float(dt),
             float(ctx.clumping), *(float(g) for g in ctx.gamma_uvb),
             float(ctx.epsilon), float(ctx.cosmo_cool_factor),
             *(float(b) for b in ev1._boundary_columns(ctx)),
             cuda_build.stream_of(nd))
    cuda_build.check(err, name + " (parent build)")
    return (ev1.State1D(ndens=nd, temper=temper_out, xh=xh_out, xhe=xhe_out),
            nits, counters)


def oned_block_rows(ctx):
    """(K, bands, live lanes of the warp) of each block of "auto" tables
    in commit e7dcd29's 1D kernel, and (nodes, rows dealt, rows' slots)
    of this tree's row deal (onedim.evolve._row_deal)."""
    import torch

    from c2ray_tpu_torch.onedim import evolve as ev1
    from c2ray_tpu_torch.radiation.quadrature import packed_band_blocks

    flat, blocks = packed_band_blocks(ctx.tables, torch.float64,
                                      not ctx.isothermal, ctx.has_bb,
                                      ctx.has_pl, ctx.has_qso)
    _, slots, deal = ev1._row_deal(flat, blocks, not ctx.isothermal)
    real = [d for d in deal if d is not None]
    return ([(K, nb, min(nb, 32)) for _, _, nb, K, _ in blocks],
            (sum(d[3] for d in real), len(real), slots))
