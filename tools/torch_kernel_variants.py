"""Trial builds of kernels B (csrc/g2p.cu), H (csrc/p2g2d.cu), G
(csrc/pcdf2d.cu), I (csrc/g2p2d.cu) and E (csrc/compact.cu) on one GPU,
and G and I against a parent tree's.

    python3 tools/torch_kernel_variants.py [--parent ROOT]

Each variant is a text edit of the kernel's source as it stands, built with
`_cuda.NVCC_FLAGS` plus `-Xptxas -v` into `wgsparkl_tpu_torch/_build/variants/`
(one nvcc per variant, all started together); with --parent, ROOT's
csrc/pcdf2d.cu and csrc/g2p2d.cu (another checkout of the repository, e.g.
the parent commit unpacked with `git archive`, with the entries of this
one's parent) are built the same way as the variant `parent`.  For each it prints the
ptxas report of the kernel (registers, stack frame, spill stores and
loads, shared memory), its resident blocks an SM from
cudaOccupancyMaxActiveBlocksPerMultiprocessor, and then, in three rounds
that take the variants in turn, forward and then backward (parent,
change, change, parent), the device ms a raw launch of the C entry (CUDA
events around 20 back-to-back launches; G's parent is timed beside it
with what its callers issued around it as launches of their own, the
output's zero fill before it and the 2D substep's clone of the 16
transfer rows and its three row copies after it, as `parent+glue`) and
the host microseconds a call, for G also the device time of its kernels
a call under torch.profiler (the parent's glue is host-bound between
CUDA events); and whether its output equals the kernel's as it stands
bit for bit (G's: its particle-CDF rows and the rows it patches; the
parent's G patches none: its particle-CDF rows).

Variants of B (256 threads a block):
  as_is        the source as it stands: __launch_bounds__(256), every
               gate level's 27-node walk unrolled
  min_blocks_3 __launch_bounds__(256, 3): registers capped for three blocks
  rolled_ox    the level-2 walk (the pairwise ghost) not unrolled over ox
  rolled_oxoy  the level-2 walk not unrolled over ox and oy
  float4_v     the window velocity in shared memory as float4: one 16-byte
               read a node
Variants of H (128 threads a block):
  as_is        the source as it stands: the driver's default shared-memory
               carveout
  max_carveout the largest shared-memory carveout requested before every
               launch
Variants of G (256 threads a block):
  as_is        the source as it stands: one block a job slot, the whole
               output written and the sorted rows patched in place (each
               variant on its own copy of them)
  min_blocks_6 __launch_bounds__(256, 6): registers capped for six blocks
  no_job_zeros an ungated job writes nothing (a measurement of what its
               zeros cost: its lanes differ)
  threads_128  blocks of 128 threads
  parent       ROOT's kernel (with --parent): it writes only the gated
               jobs' lanes, so `parent+glue` zeroes the output first and
               then clones and patches the rows as the parent's substep did
Variants of I (256 threads a block):
  as_is        the source as it stands: one block a job slot
  min_blocks_4 __launch_bounds__(256, 4): registers capped for four blocks
  ungated_only every job through the ungated walk (a measurement of what
               the gated code's registers cost the others: its gated jobs'
               rows differ)
  no_chan_free the chan-free node CDF left out (a measurement of its
               registers; on these gathered-mode inputs the rows agree)
  parent       ROOT's kernel (with --parent)
Variants of E:
  as_is        the source as it stands: one launch, tiles of 16384 lanes
               (512 threads of 32 flags)
  tile_8k      tiles of 8192 lanes (256 threads of 32 flags): twice the
               tiles, so twice the look-back rounds
  tile_4k      tiles of 4096 lanes (256 threads of 16 flags)

Inputs, from chip_smoke.py's scenes at full size: B on a substep of the 3D
main path lowered 3 cells onto its paddle (the `g2p` entry's); H on a
substep of the 2D column lowered 1.5 cells into its floor (the `p2g2d`
entry's) and on a substep of the 2D neo-Hookean path (`p2g2d_neo`); I on
the same 2D column substep (`g2p2d`), again with its job table cut to the
live slots (no dead slot: what the ~maxj - live idle blocks cost), and on
the neo-Hookean substep; G on the same column and neo-Hookean substeps and
on a substep of path 6 lowered into the floor in the chan-free mode (the
`pcdf2d` and `pcdf2d_chan_free` entries'); E on the 3D main path's and the 2D column's
block-boundary compaction (`build_jobs`' call).
Prints the card's name and power limit first.  Fails without a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import pathlib
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke  # noqa: E402

UNROLLED_OX = "#pragma unroll\n    for (int ox = 0; ox < 3; ++ox)\n"
UNROLLED_OY = "#pragma unroll\n      for (int oy = 0; oy < 3; ++oy)\n"
LAUNCH_H = "  if (maxj > 0)\n    p2g2d_kernel<<<"

# kernel: (entry symbol, threads a block, [(variant, [(old, new), ...])]);
# each old string must occur exactly once in the source.
VARIANTS = {
    "g2p": ("g2p_kernel", 256, [
        ("as_is", []),
        ("min_blocks_3", [("__launch_bounds__(NTHREADS) g2p_kernel(",
                           "__launch_bounds__(NTHREADS, 3) g2p_kernel(")]),
        ("rolled_ox", [(UNROLLED_OX, UNROLLED_OX.replace(
            "unroll\n", "unroll (LVL == 2 ? 1 : 3)\n"))]),
        ("rolled_oxoy", [(UNROLLED_OX, UNROLLED_OX.replace(
            "unroll\n", "unroll (LVL == 2 ? 1 : 3)\n")),
                         (UNROLLED_OY, UNROLLED_OY.replace(
                             "unroll\n", "unroll (LVL == 2 ? 1 : 3)\n"))]),
        ("float4_v", [
            ("__shared__ float s_v[WV_MAX * 3], s_bv[WV_MAX * 3];",
             "__shared__ __align__(16) float s_v[WV_MAX * 4];\n"
             "  __shared__ float s_bv[WV_MAX * 3];"),
            ("        s_v[n * 3 + k] =\n", "        s_v[n * 4 + k] =\n"),
            ("for (int k = 0; k < 3; ++k) s_v[n * 3 + k] = ft[k];",
             "for (int k = 0; k < 3; ++k) s_v[n * 4 + k] = ft[k];"),
            ("const float* v = &s_v[n * 3];",
             "const float4 v4 = reinterpret_cast<const float4*>(s_v)[n];\n"
             "          const float v[3] = {v4.x, v4.y, v4.z};")]),
    ]),
    "p2g2d": ("p2g2d_kernel", 128, [
        ("as_is", []),
        ("max_carveout", [(LAUNCH_H, "  if (maxj > 0)\n    cudaFuncSetAttribute(\n"
                           "        p2g2d_kernel,\n"
                           "        cudaFuncAttributePreferredSharedMemoryCarveout,\n"
                           "        cudaSharedmemCarveoutMaxShared);\n" + LAUNCH_H)]),
    ]),
    "g2p2d": ("g2p2d_kernel", 256, [
        ("as_is", []),
        ("min_blocks_4", [("__launch_bounds__(NTHREADS) g2p2d_kernel(",
                           "__launch_bounds__(NTHREADS, 4) g2p2d_kernel(")]),
        ("ungated_only", [("  if (gated)\n    g2p2d_walk<true>",
                           "  if (false)\n    g2p2d_walk<true>")]),
        ("no_chan_free", [("    if (chan_free) {", "    if (false) {")]),
    ]),
    "pcdf2d": ("pcdf2d_kernel", 256, [
        ("as_is", []),
        ("min_blocks_6", [("__launch_bounds__(NTHREADS) pcdf2d_kernel(",
                           "__launch_bounds__(NTHREADS, 6) pcdf2d_kernel(")]),
        ("no_job_zeros", [("    zero_job(out, ostride, pdata, pstride, start, len);\n",
                           "")]),
        ("threads_128", [('#include "transfer2d.cuh"\n', '#include "transfer2d.cuh"\n'
                          "#undef NTHREADS\n#define NTHREADS 128\n")]),
    ]),
    "compact": ("compact_kernel", 512, [
        ("as_is", []),
        ("tile_8k", [("#define THREADS 512\n", "#define THREADS 256\n")]),
        ("tile_4k", [("#define PER_THREAD 32 ", "#define PER_THREAD 16 "),
                     ("#define THREADS 512\n", "#define THREADS 256\n")]),
    ]),
}
# Variants whose blocks have other than their kernel's threads.
THREADS_OF = {("compact", "tile_8k"): 256, ("compact", "tile_4k"): 256,
              ("pcdf2d", "threads_128"): 128}


def parent_patch(call, out):
    """What the parent's 2D substep did after kernel G: clone the 16
    transfer rows of the sorted rows and copy rows AFF, NX..NY and
    AFF_SPARE in from G's output."""
    rows = call["args"][0]
    npad = rows.shape[1]
    pdata = rows[:16].clone()
    pdata[9] = out[0, :npad]
    pdata[10:12] = out[2:4, :npad]
    pdata[12] = out[4, :npad]


# Kernels timed against a parent tree's (--parent): the parent's kernel
# entry, and what its callers issued around it (the output's fill before
# the launch, the work on the output after it), or None.
PARENT = {"g2p2d": ("g2p2d_kernel", None),
          "pcdf2d": ("pcdf2d_kernel", (lambda out: out.zero_(), parent_patch))}


def variant_source(src: str, kernel: str, edits) -> str:
    for old, new in edits:
        n = src.count(old)
        src = src.replace(old, new)
        if n != 1:
            raise RuntimeError(f"variant edit matched {n} times: {old!r}")
    return src + (
        '\nextern "C" int variant_blocks_per_sm(int threads) {\n'
        "  int n = -1;\n"
        f"  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, {kernel}, threads, 0);\n"
        "  return n;\n}\n")


def build_all(_cuda, parent=None):
    """Build every variant, and with `parent` (a repository root) that
    tree's G and I as the variant `parent`; {(name, variant): (library
    path, ptxas lines)}."""
    out_dir = _cuda._BUILD / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = []
    for name, (kernel, _, variants) in VARIANTS.items():
        src = (_cuda._SRC / f"{name}.cu").read_text()
        for var, edits in variants:
            builds.append((name, var, kernel, _cuda._SRC,
                           variant_source(src, kernel, edits)))
        if parent is not None and name in PARENT:
            psrc = pathlib.Path(parent) / "wgsparkl_tpu_torch" / "csrc"
            builds.append((name, "parent", PARENT[name][0], psrc,
                           variant_source((psrc / f"{name}.cu").read_text(),
                                          PARENT[name][0], [])))
    jobs = []
    for name, var, kernel, inc, text in builds:
        cu = out_dir / f"{name}_{var}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{name}_{var}.so"
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-I",
               str(inc), "-o", str(lib), str(cu)]
        jobs.append((name, var, kernel, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    built = {}
    for name, var, kernel, lib, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {var}:\n{err}")
        built[(name, var)] = (lib, ptxas_lines(err, kernel))
    return built


def ptxas_lines(err: str, kernel: str):
    """The ptxas report of the entry function `kernel`."""
    lines, keep = [], False
    for line in err.splitlines():
        if "Compiling entry function" in line:
            keep = kernel in line
        elif keep and ("bytes stack frame" in line or "Used" in line):
            lines.append(line.strip())
    return lines


def capture(_cuda, fn, *args, **kwargs):
    """Run the wrapper fn(*args, **kwargs) once and return the (symbol,
    sig, args) it handed to _cuda.launch."""
    got = {}
    real = _cuda.launch

    def grab(name, symbol, sig, *a):
        got.update(symbol=symbol, sig=sig, args=a)
        real(name, symbol, sig, *a)

    _cuda.launch = grab
    try:
        fn(*args, **kwargs)
    finally:
        _cuda.launch = real
    torch.cuda.synchronize()
    return got


def caller(_cuda, lib, got, outputs, in_place=()):
    """A no-argument launcher of got's entry in lib on fresh zeroed output
    tensors (positions `outputs` of got's arguments) and fresh copies of
    the tensors it writes in place (positions `in_place`); returns (launch,
    those tensors)."""
    f = getattr(lib, got["symbol"])
    f.argtypes = [_cuda._CT[c] for c in got["sig"]] + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    args = list(got["args"])
    for i in outputs:
        args[i] = torch.zeros_like(args[i])
    for i in in_place:
        args[i] = args[i].clone()
    conv = []
    for c, a in zip(got["sig"], args):
        conv.append(ctypes.c_void_p(a.data_ptr()) if c == "p"
                    else ctypes.c_longlong(int(a)) if c == "i"
                    else ctypes.c_float(float(a)))
    conv.append(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))

    def launch():
        err = f(*conv)
        if err != 0:
            raise RuntimeError(f"{got['symbol']} failed with error {err}")

    return launch, [args[i] for i in list(outputs) + list(in_place)]


def timed(launch, reps: int = 20):
    """(device ms a launch, host microseconds a call) over reps launches."""
    launch()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    h0 = time.perf_counter()
    for _ in range(reps):
        launch()
    h1 = time.perf_counter()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps, 1e6 * (h1 - h0) / reps


def kernel_ms(call, reps: int = 20):
    """(device ms of the kernels a call, kernels a call) over reps calls
    under torch.profiler: the sum of the device events' own times, with
    no idle time between them, for calls whose host work outlasts them."""
    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                acc_events=True) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    return us / 1e3 / reps, sum(e.count for e in events) / reps


def recorded(step_pallas, step_with_diag, data, warm, shift):
    """The record of one substep after `warm` substeps, the lattice moved
    by `shift` first."""
    if shift is not None:
        data.state.particles.pos += torch.tensor(shift, device="cuda")
    state, diag = step_with_diag(data.state, data.params, data.config, warm)
    if diag.any_overflow():
        sys.exit(f"FAIL: step diagnostics: {diag.summary()}")
    rec = {}
    step_pallas(state, data.params, data.config, 1, record=rec)
    torch.cuda.synchronize()
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="root of another checkout whose G and I "
                    "are timed against these")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("FAIL: torch.cuda.is_available() is False")
    from wgsparkl_tpu_torch import _cuda
    from wgsparkl_tpu_torch.ops import compact, g2p, transfer2d
    from wgsparkl_tpu_torch.pipeline import step_pallas, step_with_diag

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    _cuda.build(list(VARIANTS))
    t0 = time.time()
    built = build_all(_cuda, args.parent)
    print(f"built {len(built)} variants in {time.time() - t0:.1f} s", flush=True)

    dev = torch.device("cuda:0")
    inputs = []

    def add_compact(what, rec):
        sids, nb_total = rec["sorted_ids"], rec["nb_total"]
        flag = torch.ones_like(sids, dtype=torch.bool)
        flag[1:] = sids[1:] != sids[:-1]
        vals = torch.clamp(sids, max=nb_total + 1).to(torch.float32)[None, :]
        got = capture(_cuda, compact.compact_flagged, vals, flag,
                      min(nb_total + 3, sids.shape[0]))
        inputs.append(("compact", what, got, [len(got["args"]) - 2,
                                              len(got["args"]) - 1]))

    def add_pcdf(what, rec, cfg, mode=()):
        args_g = ((rec["rows"], rec["ntiles"], rec["jobs"], rec["bcells"],
                   rec["jbody"], cfg.grid.cell_width, cfg.group, rec["rows"].shape[1],
                   cfg.num_colliders) + mode)
        got = capture(_cuda, transfer2d.pcdf_rows, rec["rows"].clone(), *args_g[1:])
        inputs.append(("pcdf2d", what, got, [12]))

    data = chip_smoke.full_scene(dev)
    rec = recorded(step_pallas, step_with_diag, data, 2, (0.0, -3.0, 0.0))
    cfg = data.config
    args_b = (rec["pdata"], rec["ftiles"], rec["ntiles"], rec["btable"],
              rec["jobs"], rec["bcells"], rec["jbody"], cfg.grid.cell_width,
              chip_smoke.BY, chip_smoke.GROUP, rec["rows"].shape[1],
              cfg.num_colliders, rec["moving"])
    got = capture(_cuda, g2p.g2p_rows, *args_b)
    inputs.append(("g2p", "3D main path, lowered", got, [len(got["args"]) - 2]))
    add_compact("3D main path, lowered", rec)
    del data, rec
    for what, data, warm, shift in (
            ("2D column, lowered", chip_smoke.full_scene_2d(dev), 2,
             (0.0, -1.5 * chip_smoke.H2)),
            ("2D neo-Hookean path", chip_smoke.full_scene_neo_2d(dev), 5, None)):
        rec = recorded(step_pallas, step_with_diag, data, warm, shift)
        cfg = data.config
        args_h = (rec["pdata"], rec["ntiles"], rec["btable"], rec["jobs"],
                  rec["bcells"], rec["jbody"], cfg.grid.cell_width,
                  cfg.num_colliders)
        got = capture(_cuda, transfer2d.p2g_tiles, *args_h)
        n = len(got["args"])
        inputs.append(("p2g2d", what, got, [n - 2, n - 1]))
        add_pcdf(what, rec, cfg)
        args_i = ((rec["pdata"], rec["ftiles"], rec["ntiles"], rec["btable"])
                  + args_h[3:7] + (cfg.group, rec["rows"].shape[1],
                                   cfg.num_colliders))
        got = capture(_cuda, transfer2d.g2p_rows, *args_i)
        inputs.append(("g2p2d", what, got, [len(got["args"]) - 2]))
        if what.startswith("2D column"):
            add_compact(what, rec)
            # The job table cut to its live slots: no dead slot's block.
            live = int((rec["jobs"]["len"] > 0).sum())
            cut = ((rec["pdata"], rec["ftiles"][:live], rec["ntiles"][:live],
                    rec["btable"], {k: v[:live] for k, v in rec["jobs"].items()},
                    rec["bcells"][:live], rec["jbody"][:live]) + args_i[7:])
            got = capture(_cuda, transfer2d.g2p_rows, *cut)
            inputs.append(("g2p2d", f"{what}, live slots only ({live})", got,
                           [len(got["args"]) - 2]))
        del data, rec
    data = chip_smoke.full_scene_stirred_2d(dev, True)
    rec = recorded(step_pallas, step_with_diag, data, 2, (0.0, -1.5 * chip_smoke.H2))
    add_pcdf("path 6 chan-free, lowered", rec, data.config,
             (rec["btable"], rec["alldesc"], True))
    del data, rec
    torch.cuda.empty_cache()

    for name, what, got, outputs in inputs:
        kernel, threads, variants = VARIANTS[name]
        names = [var for var, _ in variants]
        if (name, "parent") in built:
            names = ["parent"] + names
        runs = {}
        for var in names:
            lib_path, report = built[(name, var)]
            lib = ctypes.CDLL(str(lib_path))
            call = got
            if name == "compact" and var != "parent":
                # Status words for the smallest tile (4096 lanes), zeroed.
                a = call["args"]
                call = dict(call, args=a[:5] + (torch.zeros(
                    2 + -(-int(a[3]) // 4096), dtype=torch.int32, device=dev),) + a[6:])
            outs_at = ([len(call["args"]) - 2, len(call["args"]) - 1]
                       if name == "compact" else outputs)
            # G patches the sorted rows in place (the parent's G only reads
            # them).
            in_place = [0] if name == "pcdf2d" and var != "parent" else []
            launch, outs = caller(_cuda, lib, call, outs_at, in_place)
            if var == "parent" and PARENT[name][1]:
                PARENT[name][1][0](outs[0])
            launch()
            torch.cuda.synchronize()
            runs[var] = (launch, outs, lib, report)
        ref = runs["as_is"][1]
        print(f"== {name} ({kernel}) on the {what}", flush=True)
        for var, (launch, outs, lib, report) in runs.items():
            same = all(torch.equal(a, b) for a, b in zip(outs, ref))
            lib.variant_blocks_per_sm.restype = ctypes.c_int
            nt = THREADS_OF.get((name, var), threads)
            blocks = lib.variant_blocks_per_sm(nt)
            print(f"{name} {var}: {'; '.join(report)}; {blocks} blocks of "
                  f"{nt} an SM; output equal to as_is: {same}", flush=True)
        if "parent" in runs and PARENT[name][1]:
            launch, outs = runs["parent"][:2]
            fill, after = PARENT[name][1]
            runs["parent+glue"] = (
                lambda launch=launch, out=outs[0], fill=fill, after=after:
                (fill(out), launch(), after(got, out)), *runs["parent"][1:])
        order = list(runs)
        for rnd in range(3):
            for var in order + order[::-1]:
                ms, host_us = timed(runs[var][0])
                print(f"{name} {var} round {rnd}: {ms:.4f} ms device a launch, "
                      f"{host_us:.1f} us host a call", flush=True)
                if "parent+glue" in runs:
                    kms, nk = kernel_ms(runs[var][0])
                    print(f"{name} {var} round {rnd}: {kms:.4f} ms of kernels a "
                          f"call ({nk:.1f} kernels, profiler)", flush=True)
    print(f"card: {card}", flush=True)


if __name__ == "__main__":
    main()
