"""Importers of the reference LibreASR's artifacts: its torch
checkpoints (torch_import) and its youtokentome tokenizers
(yttm_import), into the JAX layout and the LABPE1 tokenizer format the
port's bundles hold. Numpy only; scripts/import_reference.py turns a
reference release archive into a bundle."""
