"""The benchmark of ``grape_tpu_torch`` (see ``README.md`` beside this
file)."""
