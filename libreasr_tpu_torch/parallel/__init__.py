"""Multi-GPU training and serving: the (data, model[, pipe]) mesh over
torch.distributed process groups or over a list of devices, the
process bootstrap, GPipe pipelining of a uniform LSTM stack, and the
per-row random draws that keep a data-parallel step equal to the
single-process step on the global batch.

Nothing here calls torch.distributed when it is imported.
"""
