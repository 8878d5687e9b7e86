"""Whisper's log-mel front end, on the host: the JAX package's
``ops/logmel.py``.

16 kHz mono → STFT (n_fft 400, hop 160, Hann) → 80-bin slaney mel filter
bank → log10 → clamp to (max - 8) → (x + 4) / 4.  Computed in numpy on the
host, so the device program keeps one static shape ([80, 3000] per 30 s
window).  The filter bank is computed here (:func:`mel_filters`), the same
float64 arithmetic as the slaney bank the JAX package takes from
``transformers.audio_utils.mel_filter_bank``, so the port needs no
``transformers``.

Long audio is cut into 30 s windows by the servable (:func:`chunk_waveform`);
each window is one sample.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
N_MELS = 80
CHUNK_SECONDS = 30
CHUNK_SAMPLES = SAMPLE_RATE * CHUNK_SECONDS
N_FRAMES = CHUNK_SAMPLES // HOP  # 3000

# The slaney mel scale: linear below 1 kHz (3 mels per 200 Hz), logarithmic
# above it (27 mels per factor 6.4).
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = 15.0
_LOGSTEP = 27.0 / np.log(6.4)

_mel_filters = None


def _hz_to_mel(hz: float) -> float:
    if hz >= _MIN_LOG_HZ:
        return _MIN_LOG_MEL + np.log(hz / _MIN_LOG_HZ) * _LOGSTEP
    return 3.0 * hz / 200.0


def _mel_to_hz(mels: np.ndarray) -> np.ndarray:
    hz = 200.0 * mels / 3.0
    log = mels >= _MIN_LOG_MEL
    hz[log] = _MIN_LOG_HZ * np.exp((mels[log] - _MIN_LOG_MEL) / _LOGSTEP)
    return hz


def mel_filters() -> np.ndarray:
    """[n_freqs=201, n_mels=80] slaney-normalised mel filter bank, 0-8 kHz:
    triangles between consecutive mel-spaced centres over the FFT bins'
    frequencies, each scaled by 2 / its width in Hz (equal area)."""
    global _mel_filters
    if _mel_filters is None:
        centres = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2),
                                         N_MELS + 2))
        fft_hz = np.linspace(0, SAMPLE_RATE // 2, 1 + N_FFT // 2)
        slopes = centres[None, :] - fft_hz[:, None]
        width = np.diff(centres)
        down = -slopes[:, :-2] / width[:-1]
        up = slopes[:, 2:] / width[1:]
        bank = np.maximum(np.zeros(1), np.minimum(down, up))
        bank *= (2.0 / (centres[2:] - centres[:N_MELS]))[None, :]
        _mel_filters = bank.astype(np.float32)
    return _mel_filters


def log_mel_spectrogram(audio: np.ndarray, pad_to_chunk: bool = True) -> np.ndarray:
    """float32 mono waveform at 16 kHz → [80, 3000] log-mel features (with
    ``pad_to_chunk``, the first 30 s zero-padded or cut to a window).

    Center-padded reflect STFT, power spectrum, mel, log10 clamped to
    (max - 8), then (x + 4) / 4, as Whisper's feature extractor.
    """
    audio = np.asarray(audio, dtype=np.float32).reshape(-1)
    if pad_to_chunk:
        audio = audio[:CHUNK_SAMPLES]
        if audio.shape[0] < CHUNK_SAMPLES:
            audio = np.pad(audio, (0, CHUNK_SAMPLES - audio.shape[0]))
    window = np.hanning(N_FFT + 1)[:-1].astype(np.float32)
    padded = np.pad(audio, (N_FFT // 2, N_FFT // 2), mode="reflect")
    n_frames = 1 + (padded.shape[0] - N_FFT) // HOP
    idx = np.arange(N_FFT)[None, :] + HOP * np.arange(n_frames)[:, None]
    frames = padded[idx] * window
    stft = np.fft.rfft(frames, n=N_FFT, axis=-1)
    magnitudes = np.abs(stft[:-1]) ** 2  # the last frame dropped, as Whisper
    mel = magnitudes @ mel_filters()  # [frames, n_mels]
    log_spec = np.log10(np.clip(mel, 1e-10, None))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.T.astype(np.float32)  # [80, frames]


def chunk_waveform(audio: np.ndarray) -> list[np.ndarray]:
    """A waveform cut into 30 s windows, the last one short
    (:func:`log_mel_spectrogram` pads it); empty audio is one empty window."""
    audio = np.asarray(audio, dtype=np.float32).reshape(-1)
    if audio.shape[0] == 0:
        return [audio]
    return [audio[i: i + CHUNK_SAMPLES] for i in range(0, audio.shape[0], CHUNK_SAMPLES)]
