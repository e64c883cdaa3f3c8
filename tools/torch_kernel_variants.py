"""Trial builds of kernels B (csrc/g2p.cu) and H (csrc/p2g2d.cu) on one GPU.

    python3 tools/torch_kernel_variants.py

Each variant is a text edit of the kernel's source as it stands, built with
`_cuda.NVCC_FLAGS` plus `-Xptxas -v` into `wgsparkl_tpu_torch/_build/variants/`
(one nvcc per variant, all started together).  For each it prints the
ptxas report of the kernel (registers, stack frame, spill stores and
loads, shared memory), its resident blocks an SM from
cudaOccupancyMaxActiveBlocksPerMultiprocessor, and then, in three rounds
that take the variants in turn, the device ms a launch (CUDA events around
20 back-to-back launches) and the host microseconds a call; and whether
its output equals the kernel's as it stands bit for bit.

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

Inputs, from chip_smoke.py's scenes at full size: B on a substep of the 3D
main path lowered 3 cells onto its paddle (the `g2p` entry's); H on a
substep of the 2D column lowered 1.5 cells into its floor (the `p2g2d`
entry's) and on a substep of the 2D neo-Hookean path (`p2g2d_neo`).
Prints the card's name and power limit first.  Fails without a CUDA
device.
"""

from __future__ import annotations

import ctypes
import os
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
}


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


def build_all(_cuda):
    """Build every variant; {(name, variant): (library path, ptxas lines)}."""
    out_dir = _cuda._BUILD / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, (kernel, _, variants) in VARIANTS.items():
        src = (_cuda._SRC / f"{name}.cu").read_text()
        for var, edits in variants:
            cu = out_dir / f"{name}_{var}.cu"
            cu.write_text(variant_source(src, kernel, edits))
            lib = out_dir / f"lib{name}_{var}.so"
            cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                   str(_cuda._SRC), "-o", str(lib), str(cu)]
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


def capture(_cuda, fn, *args):
    """Run the wrapper fn(*args) once and return the (symbol, sig, args)
    it handed to _cuda.launch."""
    got = {}
    real = _cuda.launch

    def grab(name, symbol, sig, *a):
        got.update(symbol=symbol, sig=sig, args=a)
        real(name, symbol, sig, *a)

    _cuda.launch = grab
    try:
        fn(*args)
    finally:
        _cuda.launch = real
    torch.cuda.synchronize()
    return got


def caller(_cuda, lib, got, outputs):
    """A no-argument launcher of got's entry in lib on fresh zeroed output
    tensors (positions `outputs` of got's arguments); returns (launch,
    outputs)."""
    f = getattr(lib, got["symbol"])
    f.argtypes = [_cuda._CT[c] for c in got["sig"]] + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    args = list(got["args"])
    for i in outputs:
        args[i] = torch.zeros_like(args[i])
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

    return launch, [args[i] for i in outputs]


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
    if not torch.cuda.is_available():
        sys.exit("FAIL: torch.cuda.is_available() is False")
    from wgsparkl_tpu_torch import _cuda
    from wgsparkl_tpu_torch.ops import g2p, transfer2d
    from wgsparkl_tpu_torch.pipeline import step_pallas, step_with_diag

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    _cuda.build(["g2p", "p2g2d"])
    t0 = time.time()
    built = build_all(_cuda)
    print(f"built {len(built)} variants in {time.time() - t0:.1f} s", flush=True)

    dev = torch.device("cuda:0")
    inputs = []
    data = chip_smoke.full_scene(dev)
    rec = recorded(step_pallas, step_with_diag, data, 2, (0.0, -3.0, 0.0))
    cfg = data.config
    args_b = (rec["pdata"], rec["ftiles"], rec["ntiles"], rec["btable"],
              rec["jobs"], rec["bcells"], rec["jbody"], cfg.grid.cell_width,
              chip_smoke.BY, chip_smoke.GROUP, rec["rows"].shape[1],
              cfg.num_colliders, rec["moving"])
    got = capture(_cuda, g2p.g2p_rows, *args_b)
    inputs.append(("g2p", "3D main path, lowered", got, [len(got["args"]) - 2]))
    del data, rec
    for what, data, warm, shift in (
            ("2D column, lowered", chip_smoke.full_scene_2d(dev), 2,
             (0.0, -1.5 * chip_smoke.H2)),
            ("2D neo-Hookean path", chip_smoke.full_scene_neo_2d(dev), 5, None)):
        rec = recorded(step_pallas, step_with_diag, data, warm, shift)
        args_h = (rec["pdata"], rec["ntiles"], rec["btable"], rec["jobs"],
                  rec["bcells"], rec["jbody"], data.config.grid.cell_width,
                  data.config.num_colliders)
        got = capture(_cuda, transfer2d.p2g_tiles, *args_h)
        n = len(got["args"])
        inputs.append(("p2g2d", what, got, [n - 2, n - 1]))
        del data, rec
    torch.cuda.empty_cache()

    for name, what, got, outputs in inputs:
        kernel, threads, variants = VARIANTS[name]
        runs = {}
        for var, _ in variants:
            lib_path, report = built[(name, var)]
            lib = ctypes.CDLL(str(lib_path))
            launch, outs = caller(_cuda, lib, got, outputs)
            launch()
            torch.cuda.synchronize()
            runs[var] = (launch, outs, lib, report)
        ref = runs["as_is"][1]
        print(f"== {name} ({kernel}) on the {what}", flush=True)
        for var, (launch, outs, lib, report) in runs.items():
            same = all(torch.equal(a, b) for a, b in zip(outs, ref))
            lib.variant_blocks_per_sm.restype = ctypes.c_int
            blocks = lib.variant_blocks_per_sm(threads)
            print(f"{name} {var}: {'; '.join(report)}; {blocks} blocks of "
                  f"{threads} an SM; output equal to as_is: {same}", flush=True)
        for rnd in range(3):
            for var, (launch, _, _, _) in runs.items():
                ms, host_us = timed(launch)
                print(f"{name} {var} round {rnd}: {ms:.4f} ms device a launch, "
                      f"{host_us:.1f} us host a call", flush=True)
    print(f"card: {card}", flush=True)


if __name__ == "__main__":
    main()
