"""sdrangel_tpu — an accelerator-native software-defined-radio DSP framework.

A from-scratch re-design of the capabilities of SDRangel (v4.0.6) for an
accelerator (today one NVIDIA H100, or four over NVLink): block-processing
pure functions over (channel, time) arrays, compiled with jax/XLA, scaled
over a `jax.sharding.Mesh` with XLA collectives.

Layer map (mirrors reference SURVEY.md §1, re-architected for the device):
  dsp/       — kernel library (decimators, NCO, fft filters, resamplers,
               discriminators, AGC, squelch, Goertzel, PLLs, designers)
  channels/  — demodulators & modulators (NFM/AM/SSB/WFM/BFM/LoRa, Tx mods)
  io/        — .sdriq file I/O, synthetic test source, WAV audio, UDP egress
  runtime/   — host block-pipeline engine, device sets, settings/presets
  parallel/  — mesh construction, halo exchange, sharded channel banks
  api/       — REST control plane (swagger-path-compatible subset)
"""

__version__ = "0.1.0"
