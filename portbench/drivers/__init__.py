"""The drivers of the traffic mixes: each a module with ``run(run)`` that
sets up the cell, measures inside ``run.window()``, compares the outputs
with the plain reference and returns the readings."""

# The configuration's keys that the port's PipelineConfig takes.
PIPELINE_KEYS = ("n_channels", "block_len", "fs", "fft_impl", "lag_method", "ctrl_gain",
                 "ctrl_scale", "phase_alpha", "min_corr_mag", "sync_threshold")


def pipeline_config(cfg: dict):
    """The port's PipelineConfig as the configuration states it."""
    from coherent_rtlsdr_tpu_torch.pipeline.state import PipelineConfig

    return PipelineConfig(**{k: cfg[k] for k in PIPELINE_KEYS})
