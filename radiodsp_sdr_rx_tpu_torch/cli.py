"""Command-line receiver app — the framework's equivalent of the reference
appliance (tune, demodulate, scope), file-driven instead of antenna-driven
(``radiodsp_sdr_rx_tpu/cli.py``, the same subcommands, flags and output).

  python -m radiodsp_sdr_rx_tpu_torch demod capture.wav --mode usb \
      --vfo 7200000 --center 7190000 --out audio.wav
  python -m radiodsp_sdr_rx_tpu_torch scope capture.wav --center 7050000
  python -m radiodsp_sdr_rx_tpu_torch stream capture.wav --mode usb ...   (native ring feeder)

Mirrors the reference's control surface (mode/filter/AGC/NR/PBT/step,
RDSP_controls.h) as flags instead of a rotary encoder.

Every subcommand but ``info`` runs on the CUDA card and raises without one.
``main(argv, device="cpu")`` runs the plain PyTorch versions on the CPU
instead (the tests do); there is no flag for it and no fallback.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _add_rx_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("input", help="IQ capture: stereo WAV (L=I, R=Q) or raw cs16")
    p.add_argument("--mode", default="usb",
                   choices=["cw-n", "cw", "usb", "lsb", "am", "sam", "rtty"])
    p.add_argument("--vfo", type=float, default=None,
                   help="tuned frequency Hz (default: capture center)")
    p.add_argument("--center", type=float, default=7_050_000.0,
                   help="RF center frequency of the capture")
    p.add_argument("--agc", default="medium", choices=["off", "fast", "medium", "slow"])
    p.add_argument("--nr", default="off",
                   choices=["off", "notch", "dnr1", "dnr2", "dnr3", "dnr4",
                            "spec1", "spec2", "spec3", "spec4"])
    p.add_argument("--pbt-lo", type=float, default=300.0)
    p.add_argument("--pbt-hi", type=float, default=4000.0)
    p.add_argument("--raw", action="store_true", help="input is raw cs16")
    # ON by default like the reference boot (startAutoI2SerrorDetection,
    # RadioDSP_SDR_RX.ino:117); the detector re-scores every segment and
    # switches after 3 consecutive disagreeing segments (mid-stream slips)
    p.add_argument("--no-iq-repair", dest="iq_repair", action="store_false",
                   help="disable automatic I2S slip detection+repair")
    p.set_defaults(iq_repair=True)
    p.add_argument("--swap-iq", action="store_true",
                   help="swap I/Q channels (preProcessor.swapIQ, manual)")
    p.add_argument("--play", action="store_true",
                   help="play demodulated audio live (sounddevice/aplay/"
                        "paplay/ffplay, whichever exists; no-op headless)")
    p.add_argument("--play-cmd", default=None,
                   help="custom audio sink command reading s16le stereo on "
                        "stdin (overrides --play discovery)")


_MODE_MAP = {
    "cw-n": "CW_NARROW", "cw": "CW", "usb": "USB", "lsb": "LSB",
    "am": "AM", "sam": "SAM", "rtty": "RTTY",
}


def _make_sink(args, fs):
    """AudioSink from --play/--play-cmd (None when playback is off)."""
    if not (getattr(args, "play", False) or getattr(args, "play_cmd", None)):
        return None
    import shlex

    from radiodsp_sdr_rx_tpu_torch.utils.audio_sink import AudioSink

    cmd = shlex.split(args.play_cmd) if args.play_cmd else None
    sink = AudioSink(fs, channels=2, command=cmd)
    if not sink.available:
        print("audio: no playback backend found (sounddevice/aplay/paplay/"
              "ffplay) — continuing silent", file=sys.stderr)
        return None
    print(f"audio: playing via {sink.backend}", file=sys.stderr)
    return sink


def _build_config(args):
    from radiodsp_sdr_rx_tpu_torch.models.config import (
        AGCMode, DemodMode, NRMode, ReceiverConfig,
    )

    vfo = args.vfo if args.vfo is not None else args.center
    return ReceiverConfig(
        mode=DemodMode[_MODE_MAP[args.mode]],
        vfo_freq=vfo,
        capture_center_freq=args.center,
        agc=AGCMode[args.agc.upper()],
        nr=NRMode[args.nr.upper()],
        pbt_lo=args.pbt_lo,
        pbt_hi=args.pbt_hi,
        auto_iq_repair=getattr(args, "iq_repair", False),
        swap_iq=getattr(args, "swap_iq", False),
    )


def _build_receiver(args):
    from radiodsp_sdr_rx_tpu_torch.models.receiver import Receiver

    cfg = _build_config(args)
    return Receiver(cfg, args.device), cfg


def _load_iq(args):
    from radiodsp_sdr_rx_tpu_torch.utils import io as io_utils

    if args.raw or args.input.endswith((".cs16", ".raw", ".iq")):
        return io_utils.read_raw_iq(args.input), 44117.64706
    return io_utils.read_iq_wav(args.input)


def _stereo(out) -> np.ndarray:
    """(n, 2) audio on the host: L and R in one copy."""
    import torch

    return torch.stack([out["audio_l"], out["audio_r"]], 1).cpu().numpy()


def cmd_demod(args) -> int:
    from radiodsp_sdr_rx_tpu_torch.utils import io as io_utils

    iq, fs = _load_iq(args)
    n = (len(iq) // 128) * 128
    iq = iq[:n]
    rx, cfg = _build_receiver(args)
    t0 = time.perf_counter()
    # the whole capture in one call; the audio's copy to the host waits for it
    out, _ = rx.process(np.asarray(iq), rx.init_state())
    audio = _stereo(out)
    dt = time.perf_counter() - t0
    io_utils.write_wav(args.out, audio, fs)
    rt = n / fs
    print(f"{args.input}: {n} samples ({rt:.1f}s) {cfg.mode.value} @ "
          f"{cfg.vfo_freq/1e6:.6f} MHz -> {args.out} "
          f"[{dt:.2f}s, {rt/dt:.0f}x real time]")
    sink = _make_sink(args, fs)
    if sink is not None:
        # paced playback of the rendered capture: pace off wall-clock vs
        # samples pushed (a fixed half-block sleep fed the sink at 2x real
        # time and overflowed its drop-oldest queue after ~3 s), keeping a
        # 2-block lead so the sink never starves
        t_start = time.perf_counter()
        lead = 2 * 16384 / fs
        for off in range(0, len(audio), 16384):
            wait = off / fs - (time.perf_counter() - t_start) - lead
            if wait > 0:
                time.sleep(wait)
            sink.write(audio[off:off + 16384])
        sink.close()
        print(f"audio: {sink.stats}", file=sys.stderr)
    return 0


def scope_metrics(args, iq: np.ndarray, fs: float) -> dict:
    """``scope``'s metrics of the capture ``iq`` on the device: the raw IQ,
    and with ``--dual`` the receiver's audio, through ``analyze``."""
    import torch

    from radiodsp_sdr_rx_tpu_torch.models.metrics import analyze, scope_init
    from radiodsp_sdr_rx_tpu_torch.utils.convert import resolve_device

    dev = resolve_device(args.device)
    n = min(len(iq), 128 * 30 * 40)
    n = (n // 128) * 128
    iq_d = torch.from_numpy(np.ascontiguousarray(iq[:n])).to(dev)
    if args.dual:
        # demod the capture so the AF-FFT pane shows real audio
        rx, _ = _build_receiver(args)
        out, _ = rx.process(iq_d, rx.init_state())
        audio = out["audio_l"][: (len(out["audio_l"]) // 512) * 512]
    else:
        audio = torch.zeros(max((n // 512) * 512, 512), device=dev)
    m, _ = analyze(iq_d, audio, scope_init(dev), sample_rate=fs)
    return m


def scope_text(m: dict, fs: float, center: float, dual: bool) -> str:
    """``scope``'s printout of the metrics ``m`` (tensors or arrays)."""
    from radiodsp_sdr_rx_tpu_torch.utils.display import (
        render_double_spectrum_ascii, render_spectrum_ascii,
        render_waterfall_ascii,
    )

    def host(v):
        return v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)

    span = fs / 1e3
    lines = [f"panadapter: ±{span/2:.1f} kHz around {center/1e6:.6f} MHz"]
    if dual:
        # Update_DoubleSpectrum layout (RDSP_display.h:380-401)
        lines.append(render_double_spectrum_ascii(
            host(m["view"]), host(m["audio_spectrum"])[-1]))
    else:
        lines.append(render_spectrum_ascii(host(m["view"])))
    lines.append("-" * 128)
    lines.append(render_waterfall_ascii(host(m["waterfall"])))
    s = float(m["s_units"])
    plus = float(m["s9_plus_db"])
    lines.append(f"S-meter: S{s:.0f}" + (f"+{plus:.0f}dB" if plus > 0 else ""))
    return "\n".join(lines)


def cmd_scope(args) -> int:
    iq, fs = _load_iq(args)
    print(scope_text(scope_metrics(args, iq, fs), fs, args.center, args.dual))
    return 0


def cmd_stream(args) -> int:
    """Real-time-style streaming through the native ring-buffer feeder."""
    from radiodsp_sdr_rx_tpu_torch.utils import io as io_utils
    from radiodsp_sdr_rx_tpu_torch.utils import native_io

    iq, fs = _load_iq(args)
    rx, cfg = _build_receiver(args)
    sink = _make_sink(args, fs)
    ring = native_io.IQRing(1 << 16)
    block = args.block
    state = rx.init_state()
    outs = []
    pos = 0
    t0 = time.perf_counter()
    while pos < len(iq) or ring.available >= block:
        # producer side (capture thread stand-in); partial pushes retry on the
        # next loop after the consumer drains — nothing is silently skipped
        if pos < len(iq):
            pos += ring.push_complex(iq[pos : pos + block])
        # consumer side: drain in model blocks, each block's audio copied to
        # the host once
        while ring.available >= block:
            seg = ring.pop_complex(block)
            out, state = rx.process(np.asarray(seg), state)
            if sink is not None:
                stereo = _stereo(out)
                sink.write(stereo)
                al = stereo[:, 0]
            else:
                al = out["audio_l"].cpu().numpy()
            outs.append(al)
    audio = np.concatenate(outs) if outs else np.zeros(0, np.float32)
    dt = time.perf_counter() - t0
    io_utils.write_wav(args.out, audio, fs)
    stats = ring.stats
    if sink is not None:
        sink.close()
        print(f"audio: {sink.stats}", file=sys.stderr)
    print(f"streamed {stats['popped']} samples in {dt:.2f}s "
          f"(dropped {stats['dropped']}) -> {args.out}")
    return 0


def cmd_tui(args) -> int:
    """Live appliance: keyboard tuning + panadapter/waterfall/S-meter repaint
    at the reference cadence (loop(), RadioDSP_SDR_RX.ino:195-233).

    Keys: ←/→ or ,/. tune (encoder)  m menu toggle  ↑/↓ menu level
          a BUTTON_D3 (mode/filter/scope)  b BUTTON_D6 (step/NR/AGC)
          l/h select PBT edge (menu level 4)  q quit
    """
    import select
    import sys as _sys

    from radiodsp_sdr_rx_tpu_torch.models.appliance import Appliance

    iq, fs = _load_iq(args)
    cfg = _build_config(args)
    app = Appliance(cfg, block=args.block, device=args.device)
    sink = _make_sink(args, fs)
    n_blocks = len(iq) // args.block
    if n_blocks == 0:
        print("capture shorter than one block", file=sys.stderr)
        return 1
    interactive = _sys.stdin.isatty() and not args.frames
    paint_interval = 0.175   # reference repaint throttle 0-200 ms (ino:209)

    def read_events(timeout=0.0):
        evs = []
        if not interactive:
            return evs
        while select.select([_sys.stdin], [], [], timeout)[0]:
            ch = _sys.stdin.read(1)
            timeout = 0.0
            if ch == "\x1b":               # arrow keys
                rest = _sys.stdin.read(2)
                ch = {"[C": ".", "[D": ",", "[A": "U", "[B": "D"}.get(rest, "")
            if ch in (".",):
                evs.append(("encoder", +1))
            elif ch in (",",):
                evs.append(("encoder", -1))
            elif ch == "U":
                evs.append(("encoder", +1) if app.plane.menu_mode else ("menu",))
            elif ch == "D":
                evs.append(("encoder", -1) if app.plane.menu_mode else ("menu",))
            elif ch == "m":
                evs.append(("menu",))
            elif ch == "a":
                evs.append(("a",))
            elif ch == "b":
                evs.append(("b",))
            elif ch == "l":
                evs.append(("pbt", "lo"))
            elif ch == "h":
                evs.append(("pbt", "hi"))
            elif ch == "q":
                raise KeyboardInterrupt
        return evs

    def run_loop():
        last_paint = 0.0
        loops = 0
        while True:
            blk = (loops % n_blocks) * args.block
            seg = np.asarray(iq[blk: blk + args.block], np.complex64)
            try:
                out = app.step(seg, events=read_events())
                if sink is not None:
                    sink.write(_stereo(out))
            except KeyboardInterrupt:
                return 0
            now = time.perf_counter()
            if now - last_paint >= paint_interval or not interactive:
                frame = app.render_frame()
                if interactive:
                    _sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
                else:
                    _sys.stdout.write(frame + "\n" + "=" * 80 + "\n")
                _sys.stdout.flush()
                last_paint = now
            loops += 1
            if args.frames and loops >= args.frames:
                return 0
            if args.realtime:
                budget = args.block / fs
                spent = time.perf_counter() - now
                if budget > spent:
                    time.sleep(budget - spent)

    try:
        if not interactive:
            return run_loop()
        import termios
        import tty

        fd = _sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        try:
            tty.setcbreak(fd)
            return run_loop()
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
            _sys.stdout.write("\n")
    finally:
        if sink is not None:
            sink.close()
            print(f"audio: {sink.stats}", file=sys.stderr)


def cmd_scan(args) -> int:
    """Band scanner: channelize the capture and print the activity map."""
    from radiodsp_sdr_rx_tpu_torch.models.channelized import ChannelizedBank

    iq, fs = _load_iq(args)
    m = args.channels
    n = (len(iq) // m) * m
    bank = ChannelizedBank(n_channels=m, sample_rate=fs, demod="power", device=args.device)
    out, _ = bank.process(iq[:n], bank.init_state())
    power = out["power"].cpu().numpy()
    order = np.argsort(power)[::-1]
    noise_floor = float(np.median(power))
    print(f"{args.input}: {m} channels x {fs/m:.0f} Hz, "
          f"floor {10*np.log10(max(noise_floor,1e-20)):.1f} dBfs")
    shown = 0
    for k in order:
        snr = 10 * np.log10(power[k] / max(noise_floor, 1e-20))
        if snr < args.min_snr or shown >= args.top:
            break
        freq = bank.channel_freq(int(k), args.center)
        print(f"  ch {int(k):4d}  {freq/1e6:12.6f} MHz  +{snr:5.1f} dB")
        shown += 1
    if not shown:
        print("  (no channels above threshold)")
    return 0


def cmd_info(args) -> int:
    """The port's version and the CUDA cards torch sees; computes nothing."""
    import torch

    from radiodsp_sdr_rx_tpu_torch import __version__

    print(f"radiodsp_sdr_rx_tpu_torch {__version__}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    names = [torch.cuda.get_device_name(i) for i in range(count)]
    print(f"torch {torch.__version__}, CUDA devices: "
          + (f"{count} ({', '.join(names)})" if count else "none"))
    return 0


def parser() -> argparse.ArgumentParser:
    """The subcommands and their flags, as the JAX CLI has them."""
    parser = argparse.ArgumentParser(prog="radiodsp_sdr_rx_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("demod", help="demodulate an IQ capture to audio WAV")
    _add_rx_args(p)
    p.add_argument("--out", default="audio.wav")
    p.set_defaults(fn=cmd_demod)

    p = sub.add_parser("scope", help="render panadapter + waterfall + S-meter")
    _add_rx_args(p)
    p.add_argument("--dual", action="store_true",
                   help="dual-scope layout: half panadapter + AF-FFT of the "
                        "demodulated audio (Update_DoubleSpectrum)")
    p.set_defaults(fn=cmd_scope)

    p = sub.add_parser("stream", help="demodulate via the native ring feeder")
    _add_rx_args(p)
    p.add_argument("--out", default="audio.wav")
    p.add_argument("--block", type=int, default=16384)
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("tui", help="live appliance: keyboard tuning + scopes")
    _add_rx_args(p)
    p.add_argument("--block", type=int, default=4096)
    p.add_argument("--frames", type=int, default=0,
                   help="headless: render N frames then exit (no keyboard)")
    p.add_argument("--realtime", action="store_true",
                   help="pace playback at the capture sample rate")
    p.set_defaults(fn=cmd_tui)

    p = sub.add_parser("scan", help="channelized band scan (activity map)")
    p.add_argument("input")
    p.add_argument("--center", type=float, default=7_050_000.0)
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--min-snr", type=float, default=10.0)
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--raw", action="store_true")
    p.set_defaults(fn=cmd_scan)

    p = sub.add_parser("info", help="version + device info")
    p.set_defaults(fn=cmd_info)
    return parser


def main(argv=None, device=None) -> int:
    """Run one subcommand. ``device`` is where every model a subcommand
    builds runs: None, the CUDA card (raising without one), or e.g. "cpu"."""
    args = parser().parse_args(argv)
    args.device = device
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
