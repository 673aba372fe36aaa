"""Every chain route of the port in one checkout, on fixed seeded inputs, two
threaded segments each; its outputs and states saved, or two such files
compared bit for bit; or the machine code of two checkouts' builds compared
kernel by kernel. Run as a file, so that the checkout at ROOT is the one
imported:

    python radiodsp_sdr_rx_tpu_torch/diag/compare_builds.py run ROOT OUT.pt
    python radiodsp_sdr_rx_tpu_torch/diag/compare_builds.py cmp A.pt B.pt
    python radiodsp_sdr_rx_tpu_torch/diag/compare_builds.py code ROOT_A ROOT_B

``code`` reads the libraries that ``run`` built in each checkout: ptxas'
registers, stack and spills from the build logs, and each kernel's SASS
(``cuobjdump -sass``), the anonymous namespace's per-file name, the column
padding and the blank lines after a function taken out;
it prints the kernels whose SASS or ptxas lines differ (with their first
differing lines) and those in one build only.

The routes: the SSB, AM and SAM banks with and without the blanker, each with
DNR2, notch and SPEC2 folded (K1, K4, K6), SSB's staged NR routes (K1-mono,
K2a, K3, K2b), K7 at G = 2, 4 and 8 with and without the blanker, staged SAM
(K5), the staged SSB bank and ReceiverBank's LMS stages. The scene: an AM
carrier on each channel's mix with 0.02-sigma noise and three impulses of
8(1+1j), one on each segment's last sample; 67 rows a segment (a partial last
chunk), K7 35 (a partial last chunk at every G), staged SAM 64 (K5's chunk).
"""
import hashlib
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

C0 = 7_050_000.0
LIBRARIES = ("sweep_chain", "staged", "lms", "sweep_spec", "sam", "sam_wide", "sweep_denoise",
             "sweep_notch", "halo")


def scene(c, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    t = torch.arange(n, device="cuda", dtype=torch.float64) / 44117.64706
    k = torch.arange(c, device="cuda", dtype=torch.float64)[:, None]
    r = torch.rand((c, 3), generator=g, device="cuda", dtype=torch.float64)
    f = k * 1000.0 + (r[:, :1] - 0.5) * 100.0
    env = 1.0 + 0.4 * torch.sin(2 * torch.pi * (400.0 + 100.0 * r[:, 1:2]) * t)
    ang = 2 * torch.pi * f * t + 2 * torch.pi * r[:, 2:3]
    nz = torch.randn((2, c, n), generator=g, device="cuda") * 0.02
    xr = ((env * torch.cos(ang)).float() + nz[0]).contiguous()
    xi = ((env * torch.sin(ang)).float() + nz[1]).contiguous()
    for pos in (n // 5, n // 2 + 3, n - 1):
        xr[:, pos] = 8.0
        xi[:, pos] = 8.0
    return xr, xi


def run(root, out):
    sys.path.insert(0, root)
    from radiodsp_sdr_rx_tpu_torch.models.config import (
        AGCMode, DemodMode, NRMode, ReceiverConfig)
    from radiodsp_sdr_rx_tpu_torch.models.fused import (
        FusedAMBank, FusedNRBank, FusedSAMBank, FusedSSBBank)
    from radiodsp_sdr_rx_tpu_torch.models.receiver import ReceiverBank
    from radiodsp_sdr_rx_tpu_torch.utils import build
    t0 = time.time()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        list(pool.map(build.load_library, LIBRARIES))
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}

    def drive(name, bank, c, n, seed):
        xr, xi = scene(c, n, seed)
        st = bank.init_state()
        if hasattr(st, "nb_avg"):
            st = st._replace(nb_avg=torch.full_like(st.nb_avg, float(torch.hypot(xr, xi).mean())))
        for seg in range(2):
            o, st = bank.process_planar(xr, xi, st)
            res.update({f"{name}/{seg}/{k}": v.cpu() for k, v in o.items()})
        res.update({f"{name}/state/{k}": v.cpu() for k, v in st._asdict().items()
                    if torch.is_tensor(v)})

    n, fq = 67 * 128, [C0 + 1000.0 * k for k in range(6)]
    banks = {DemodMode.USB: FusedSSBBank, DemodMode.AM: FusedAMBank, DemodMode.SAM: FusedSAMBank}
    for mode, bank_cls in banks.items():
        for nb in (False, True):
            cfg = ReceiverConfig(mode=mode, vfo_freq=7_060_000.0, capture_center_freq=C0,
                                 agc=AGCMode.MEDIUM, noise_blanker=nb)
            drive(f"{mode.name}/nb{nb}", bank_cls(cfg, fq), 6, n, 1)
            for nr in (NRMode.DNR2, NRMode.NOTCH, NRMode.SPEC2):
                b = FusedNRBank(cfg.with_(nr=nr), fq)
                drive(f"{mode.name}/nb{nb}/{nr.name}/{b.route}", b, 6, n, 2)
                if mode == DemodMode.USB and not nb:
                    drive(f"USB/{nr.name}/staged", FusedNRBank(cfg.with_(nr=nr), fq, fold=False),
                          6, n, 3)
    sam = ReceiverConfig(mode=DemodMode.SAM, vfo_freq=7_060_000.0, capture_center_freq=C0,
                         agc=AGCMode.MEDIUM)
    for c in (256, 512, 1024):   # K7 at G = 2, 4, 8
        for nb in (False, True):
            b = FusedSAMBank(sam.with_(noise_blanker=nb), [C0 + 1000.0 * k for k in range(c)])
            drive(f"SAMwide/{c}/nb{nb}", b, c, 35 * 128, 4)
    drive("SAM/staged", FusedSAMBank(sam, fq, fold=False), 6, 8192, 5)
    usb = ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_200_000.0,
                         capture_center_freq=7_190_000.0, agc=AGCMode.MEDIUM)
    fu = [7_190_000.0 + 1000.0 * k for k in range(6)]
    drive("USB/staged", FusedSSBBank(usb, fu, backend="staged"), 6, n, 6)
    for nr in (NRMode.NOTCH, NRMode.DNR2):
        drive(f"ReceiverBank/{nr.name}", ReceiverBank(usb.with_(nr=nr), fu), 6, n, 7)
    torch.cuda.synchronize()
    torch.save(res, out)
    print(f"{root}: {len(res)} tensors in {time.time() - t0:.1f} s", flush=True)


def cmp(a_path, b_path):
    a, b = torch.load(a_path), torch.load(b_path)
    if sorted(a) != sorted(b):
        print(f"the files hold different tensors: {sorted(set(a) ^ set(b))}")
        return False
    bad = [k for k in sorted(a) if not torch.equal(a[k], b[k])]
    routes = {k.split("/state/")[0] if "/state/" in k else k.rsplit("/", 2)[0] for k in a}
    print(f"{len(a)} tensors over {len(routes)} routes; {len(bad)} differ")
    for k in bad:
        print(f"  {k}: max abs diff {float((a[k].double() - b[k].double()).abs().max()):.3e}")
    return not bad


# nvcc names a source's anonymous namespace after the file, with hashes of
# 8 hex digits that differ between checkouts: _GLOBAL__N__<hash>_<len>_<file>_cu[_<hash>]
_ANON = re.compile(r"(?<=_GLOBAL__N__)[0-9a-f]{8}(?=_)|(?<=_cu_)[0-9a-f]{8}")


def _kernels(root, lib):
    """{kernel: (ptxas lines, SASS digest)} of csrc/<lib>.cu's build in ROOT."""
    built = sorted(Path(root, "radiodsp_sdr_rx_tpu_torch", "_build").glob(f"lib{lib}-*.so"),
                   key=lambda p: p.stat().st_mtime)
    if not built:
        raise RuntimeError(f"no build of {lib}.cu under {root}: run `run` on it first")
    so = built[-1]
    ptxas = {}
    for block in so.with_suffix(".log").read_text().split("Compiling entry function")[1:]:
        lines = [ln.split(":", 1)[-1].strip() for ln in block.splitlines()
                 if "registers" in ln or "spill" in ln]
        ptxas[_ANON.sub("X", block.split("'")[1])] = "; ".join(lines)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    code, text = {}, {}
    for part in re.split(r"^\s*Function : ", sass, flags=re.MULTILINE)[1:]:
        name, body = part.split("\n", 1)
        # cuobjdump pads each line to the module's longest instruction and
        # follows a function with blank lines that depend on what comes next
        # in the module: compare the instructions, not the padding
        name = _ANON.sub("X", name.strip())
        text[name] = re.sub(r"[ \t]+", " ", _ANON.sub("X", body)).rstrip()
        code[name] = hashlib.sha256(text[name].encode()).hexdigest()
    _SASS[root, lib] = text
    return {k: (ptxas.get(k), code.get(k)) for k in sorted(set(ptxas) | set(code))}


_SASS: dict = {}   # (root, library) -> {kernel: its SASS as compared}


def code(root_a, root_b):
    same = True
    for lib in LIBRARIES:
        a, b = _kernels(root_a, lib), _kernels(root_b, lib)
        alike = [k for k in a if k in b and a[k] == b[k]]
        print(f"{lib}.cu: {len(alike)} kernels with the same SASS and ptxas lines")
        for k in sorted(set(a) | set(b)):
            if k in alike:
                continue
            same = False
            if k not in a or k not in b:
                print(f"  only in {root_b if k in b else root_a}: {k} ({(a.get(k) or b[k])[0]})")
            else:
                print(f"  differs: {k}: SASS {'same' if a[k][1] == b[k][1] else 'differs'}; "
                      f"ptxas {a[k][0]} -> {b[k][0]}")
                if a[k][1] != b[k][1]:   # the first lines that differ
                    la = _SASS[root_a, lib][k].splitlines()
                    lb = _SASS[root_b, lib][k].splitlines()
                    print(f"    {len(la)} -> {len(lb)} lines; first differing:")
                    for x, y in [(x, y) for x, y in zip(la, lb) if x != y][:6]:
                        print(f"    - {x.strip()}\n    + {y.strip()}")
                    n = min(len(la), len(lb))
                    for x in la[n:n + 6]:
                        print(f"    - {x.strip()}")
                    for y in lb[n:n + 6]:
                        print(f"    + {y.strip()}")
    return same


if __name__ == "__main__":
    if sys.argv[1] == "run":
        run(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "code":
        sys.exit(0 if code(sys.argv[2], sys.argv[3]) else 1)
    else:
        sys.exit(0 if cmp(sys.argv[2], sys.argv[3]) else 1)
