"""Host audio sink: live demodulated audio to the speakers
(``radiodsp_sdr_rx_tpu/utils/audio_sink.py``).

    sink = AudioSink(fs)            # picks sounddevice / aplay / paplay /
    sink.write(audio_block)         # ffplay, whichever exists
    sink.close()

- The DSP loop never blocks on audio: blocks go through a bounded queue
  drained by a writer thread; on backpressure the OLDEST block is dropped
  (counted), as the IQ ring drops (``utils/native_io.py``).
- Without sound hardware or a player, ``sink.available`` is False and
  ``write`` does nothing.
- ``command=[...]`` overrides discovery with any process that reads s16le
  interleaved PCM on stdin.
- ``write`` takes numpy or a tensor; a card's tensor is copied to the host.
"""

from __future__ import annotations

import queue
import shutil
import subprocess
import threading

import numpy as np
import torch


def _discover(fs: int, channels: int):
    """Return (kind, command) for the first workable backend, or None."""
    try:  # portaudio, if the wheel happens to exist
        import sounddevice  # noqa: F401

        return ("sounddevice", None)
    except (ImportError, OSError):   # no wheel, or no PortAudio under it -> next
        pass
    for cand in (
        ["aplay", "-q", "-t", "raw", "-f", "S16_LE", "-r", str(fs),
         "-c", str(channels)],
        ["paplay", "--raw", "--format=s16le", f"--rate={fs}",
         f"--channels={channels}"],
        ["ffplay", "-loglevel", "quiet", "-nodisp", "-autoexit",
         "-f", "s16le", "-ar", str(fs), "-ch_layout",
         "stereo" if channels == 2 else "mono", "-i", "pipe:0"],
    ):
        if shutil.which(cand[0]):
            return ("pipe", cand)
    return None


class AudioSink:
    """Non-blocking PCM sink for f32 audio blocks."""

    def __init__(self, fs: float, channels: int = 2,
                 command: list[str] | None = None,
                 queue_blocks: int = 8):
        self.fs = int(round(fs))
        self.channels = channels
        self.dropped = 0
        self.written = 0
        self._q: queue.Queue = queue.Queue(maxsize=queue_blocks)
        self._stream = None
        self._proc = None
        self._thread = None
        self._closed = False

        if command is not None:
            kind, cmd = "pipe", list(command)
        else:
            found = _discover(self.fs, channels)
            if found is None:
                self.available = False
                self.backend = None
                return
            kind, cmd = found

        if kind == "sounddevice":
            import sounddevice

            self._stream = sounddevice.OutputStream(
                samplerate=self.fs, channels=channels, dtype="int16")
            self._stream.start()
            self.backend = "sounddevice"
        else:
            try:
                self._proc = subprocess.Popen(
                    cmd, stdin=subprocess.PIPE,
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            except OSError:
                self.available = False
                self.backend = None
                return
            self.backend = cmd[0]
        self.available = True
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self):
        while True:
            buf = self._q.get()
            if buf is None:
                break
            try:
                if self._stream is not None:
                    self._stream.write(
                        np.frombuffer(buf, np.int16).reshape(
                            -1, self.channels))
                else:
                    self._proc.stdin.write(buf)
                    self._proc.stdin.flush()
                self.written += len(buf) // (2 * self.channels)
            except Exception:  # noqa: BLE001 — sink died: go unavailable
                self.available = False
                return

    def write(self, audio) -> None:
        """Queue one block. audio: (n,) mono or (n, channels) f32 in [-1, 1].
        Never blocks; on a full queue the oldest block is dropped."""
        if not self.available or self._closed:
            return
        if torch.is_tensor(audio):
            audio = audio.detach().cpu().numpy()
        a = np.asarray(audio, np.float32)
        if a.ndim == 1:
            a = np.repeat(a[:, None], self.channels, axis=1)
        pcm = (np.clip(a, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
        while True:
            try:
                self._q.put_nowait(pcm)
                return
            except queue.Full:
                try:
                    self._q.get_nowait()
                    self.dropped += 1
                except queue.Empty:
                    pass

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._thread is not None:
            while True:   # the queue may be full of undrained blocks
                try:
                    self._q.put_nowait(None)
                    break
                except queue.Full:
                    try:
                        self._q.get_nowait()
                    except queue.Empty:
                        pass
            self._thread.join(timeout=5.0)
        if self._proc is not None:
            try:
                self._proc.stdin.close()
                self._proc.wait(timeout=5.0)
            except (OSError, subprocess.TimeoutExpired):
                self._proc.kill()
        if self._stream is not None:
            self._stream.stop()
            self._stream.close()

    @property
    def stats(self) -> dict:
        return {"written": self.written, "dropped": self.dropped,
                "backend": self.backend}
