"""Corpus download: LibriSpeech's splits from OpenSLR (the JAX package's
scripts/download_corpora.py; the LibriSpeech-960 recipe's --download).

    python -m libreasr_tpu_torch.scripts.download_corpora librispeech-clean-100 --out /data

A tarball already in --out is not fetched again; it is extracted in
place (tarfile's "data" filter: no absolute paths, no links out of
--out).
"""

from __future__ import annotations

import argparse
import os
import sys
import tarfile
import urllib.request

CORPORA = {
    "librispeech-clean-100": "https://www.openslr.org/resources/12/train-clean-100.tar.gz",
    "librispeech-clean-360": "https://www.openslr.org/resources/12/train-clean-360.tar.gz",
    "librispeech-other-500": "https://www.openslr.org/resources/12/train-other-500.tar.gz",
    "librispeech-dev-clean": "https://www.openslr.org/resources/12/dev-clean.tar.gz",
    "librispeech-test-clean": "https://www.openslr.org/resources/12/test-clean.tar.gz",
}


def download(name: str, out: str):
    url = CORPORA[name]
    os.makedirs(out, exist_ok=True)
    tar_path = os.path.join(out, os.path.basename(url))
    if not os.path.exists(tar_path):
        print(f"downloading {url} ...")

        def hook(i, bs, total):
            if i % 512 == 0:
                sys.stderr.write(f"\r{i * bs / 1e6:.0f}/{total / 1e6:.0f} MB")

        urllib.request.urlretrieve(url, tar_path, reporthook=hook)
        sys.stderr.write("\n")
    print(f"extracting {tar_path} ...")
    with tarfile.open(tar_path) as tar:
        tar.extractall(out, filter="data")
    print("done")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("corpus", choices=sorted(CORPORA))
    p.add_argument("--out", default="./data")
    a = p.parse_args(argv)
    download(a.corpus, a.out)


if __name__ == "__main__":
    main()
