"""Faults planted under the timed path for the tests: each breaks the
program's resampling in one way that the cell's check has to catch."""

from __future__ import annotations


def plant(kind: str) -> None:
    """Wrap ``Resampler.resample_stream`` and ``BatchedMP3Decoder.decode_run``
    with the fault ``kind``:

    * ``state_unchanged``: each call returns its outputs but leaves the
      carried state (history, biquad states, phase; the decoders' state) as
      it found it;
    * ``half_batch``: the second half of the streams is left out (its
      output stays zero);
    * ``altered_answer``: one output sample of one stream is changed where
      it is produced (a resampled sample's low bit flipped; a decoded
      sample moved by 1000).
    """
    from esp_audio_libs_tpu_torch.models.batch import BatchedMP3Decoder
    from esp_audio_libs_tpu_torch.models.resampler import Resampler

    orig = Resampler.resample_stream

    def state_unchanged(self, *a, **k):
        st = self.get_state()
        result = orig(self, *a, **k)
        self.set_state(st)
        return result

    def half_batch(self, *a, **k):
        out, gens, clips = orig(self, *a, **k)
        out = out.clone()
        out[:, out.shape[1] // 2:] = 0
        return out, gens, clips

    def altered_answer(self, *a, **k):
        out, gens, clips = orig(self, *a, **k)
        out = out.clone()
        out[-1, 0, 0] ^= 1
        return out, gens, clips

    Resampler.resample_stream = {"state_unchanged": state_unchanged, "half_batch": half_batch,
                                 "altered_answer": altered_answer}[kind]

    decode_run = BatchedMP3Decoder.decode_run

    def decode_state_unchanged(self, *a, **k):
        snapshot = self.get_state()
        result = decode_run(self, *a, **k)
        vindex = list(self._vindex)
        self.set_state(snapshot)
        self._vindex = vindex               # the FIFO phase moves on: one format group
        return result

    def decode_half_batch(self, *a, **k):
        pcm, consumed = decode_run(self, *a, **k)[:2]
        pcm = pcm.clone()
        pcm[pcm.shape[0] // 2:] = 0
        return pcm, consumed

    def decode_altered(self, *a, **k):
        pcm, consumed = decode_run(self, *a, **k)[:2]
        pcm = pcm.clone()
        pcm[0, 0] += 1000
        return pcm, consumed

    BatchedMP3Decoder.decode_run = {"state_unchanged": decode_state_unchanged,
                                    "half_batch": decode_half_batch,
                                    "altered_answer": decode_altered}[kind]
