"""Measurement scripts of the port, each the counterpart of a script under
the repository's ``experiments/`` (run as
``python -m grape_tpu_torch.experiments.<name>``)."""
