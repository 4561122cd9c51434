"""The port's command-line tools, the counterparts of the JAX package's
examples/ CLIs, with the same arguments, output files and exit codes plus
``--device`` (``cuda`` by default, ``cpu`` for the kernels' plain
versions). Run each as ``python -m esp_audio_libs_tpu_torch.cli.<name>``:

- ``flac_to_wav``   FLAC -> WAV with STREAMINFO MD5 verification
- ``mp3_to_wav``    MP3 -> WAV, bad frames zero-filled
- ``resample_wav``  WAV -> WAV through the ``Resampler`` (exact or ``--fast``)
- ``mix_wav``       N WAVs -> one, Q15 volume and left-fold sum (``ops.dsp``)

and the serving tools:

- ``serve_fleet``   an MP3 or FLAC fleet served with slot recycling, or
                    decoded into the resampler on the device
- ``cli_worker``    warm ``flac_to_wav`` / ``mp3_to_wav`` workers (``WarmCliPool``)
- ``flac_conformance``  the FLAC conformance corpus through the decoder and CLI
- ``profile_serve_flac``  where the time of ``serve_fleet``'s FLAC fleet goes, by stage
"""
