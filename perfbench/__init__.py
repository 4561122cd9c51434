"""The benchmark of esp_audio_libs_tpu_torch on one NVIDIA H100: see harness.py."""
