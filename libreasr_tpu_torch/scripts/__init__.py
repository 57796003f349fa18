"""Command-line recipes of the port, each runnable as
`python -m libreasr_tpu_torch.scripts.<name>`."""
