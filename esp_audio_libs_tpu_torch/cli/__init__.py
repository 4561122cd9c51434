"""The port's command-line tools, the counterparts of the JAX package's
examples/ CLIs, with the same arguments, output files and exit codes plus
``--device`` (``cuda`` by default, ``cpu`` for the kernels' plain
versions). Run each as ``python -m esp_audio_libs_tpu_torch.cli.<name>``:

- ``flac_to_wav``   FLAC -> WAV with STREAMINFO MD5 verification
- ``mp3_to_wav``    MP3 -> WAV, bad frames zero-filled
- ``resample_wav``  WAV -> WAV through the ``Resampler`` (exact or ``--fast``)
- ``mix_wav``       N WAVs -> one, Q15 volume and left-fold sum (``ops.dsp``)
"""
