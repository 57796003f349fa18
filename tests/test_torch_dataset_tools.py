"""The port's dataset tools (libreasr_tpu_torch.data.create_dataset,
split and inspect) against the JAX package's, on corpora the tests
write: create_dataset and split must write the same CSV bytes (byte
for byte: either package reads the other's files), the process pool
and crash-resume must give the bytes of a plain run, and inspect's dicts
must equal JAX's with the random transforms off (tolerance 0: the same
float64 sums of the same samples)."""

import io
import os
import shutil
import wave
from contextlib import redirect_stdout

import numpy as np
import pytest

from helpers.flac_writer import write_flac
from libreasr_tpu_torch.data import audio as port_audio
from libreasr_tpu_torch.data.create_dataset import create_dataset, parse_vtt
from libreasr_tpu_torch.data.split import split_dataset

FORMATS = ["librispeech", "common-voice", "tatoeba", "tf-speech", "yt"]


def _noise(rng, n, scale=3000):
    return np.clip(np.round(rng.standard_normal(n) * scale), -32768, 32767).astype(np.int64)


def _wav(path, ints, sr=16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.asarray(ints, np.int16).tobytes())


def _librispeech(root, rng):
    """FLAC mono and stereo, a WAV at 22.05 kHz (durations that are no
    exact binary fraction), one undecodable file (a bad row), one file
    without a transcript."""
    texts = ["HELLO WORLD", "THE CAT SAT", "ON-THE MAT", "SPEECH_IS FUN",
             "IT'S DONE", "ONE TWO THREE"]
    spk = root / "19" / "198"
    spk.mkdir(parents=True)
    with open(spk / "19-198.trans.txt", "w") as tf:
        for i, text in enumerate(texts):
            utt = f"19-198-{i:04d}"
            n = int(rng.integers(9000, 20000))
            if i == 1:
                write_flac(str(spk / f"{utt}.flac"), np.stack(
                    [_noise(rng, n), _noise(rng, n)]), 16000, stereo="mid_side")
            elif i == 4:
                _wav(spk / f"{utt}.wav", _noise(rng, n), sr=22050)
            else:
                write_flac(str(spk / f"{utt}.flac"), _noise(rng, n), 16000)
            tf.write(f"{utt} {text}\n")
    (spk / "19-198-0099.flac").write_bytes(b"fLaC-but-not-really" * 8)
    write_flac(str(spk / "19-198-0100.flac"), _noise(rng, 8000), 16000)


def _common_voice(root, rng):
    clips = root / "clips"
    clips.mkdir(parents=True)
    rows = [("clip_000.mp3", "Common voice, one!"), ("clip_001.mp3", ""),
            ("clip_002.mp3", '"Quoted," she said'), ("clip_003.mp3", "NA")]
    for name, _ in rows:
        pcm = (rng.standard_normal(int(rng.integers(16000, 24000))) * 0.1)
        port_audio.write_mp3(str(clips / name), pcm.clip(-1, 1), 16000)
    with open(root / "validated.tsv", "w") as f:
        f.write("client_id\tpath\tsentence\tup_votes\n")
        for p, s in rows:
            f.write(f"c\t{p}\t{s}\t2\n")


def _tatoeba(root, rng):
    root.mkdir(parents=True)
    for i in (1234, 1235, 77):
        _wav(root / f"{i}.wav", _noise(rng, 12000))
    with open(root / "sentences.csv", "w") as f:
        f.write("1234\teng\tTom is here.\n1235\teng\tIt's late\n\n77\teng\tOK\n")
    (root / "broken.csv").write_text("1\ta\n2\tb\tc\td\n")  # refused by pandas


def _tf_speech(root, rng):
    for word in ("yes", "no", "_background_noise_"):
        d = root / word
        d.mkdir(parents=True)
        for i in range(2):
            _wav(d / f"{i:08x}_nohash_{i}.wav", _noise(rng, 16000))


def _yt(root, rng):
    root.mkdir(parents=True)
    _wav(root / "vid1.wav", _noise(rng, 48000))
    (root / "vid1.vtt").write_text(
        "WEBVTT\n\n00:00:00.500 --> 00:00:01.250\nHello <c>there</c>\n\n"
        "00:00:01.300 --> 00:00:02.900\nSecond cue\ntwo lines\n\n"
        "00:00:03.000 --> 00:00:03.100\n[MUSIC]\n")
    _wav(root / "vid2.wav", _noise(rng, 16000))  # no subtitles: no rows


BUILDERS = {"librispeech": _librispeech, "common-voice": _common_voice,
            "tatoeba": _tatoeba, "tf-speech": _tf_speech, "yt": _yt}


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    rng = np.random.default_rng(0)
    out = {}
    for fmt in FORMATS:
        if fmt == "common-voice" and not port_audio.have_mp3():
            continue
        root = tmp_path_factory.mktemp(fmt.replace("-", "_"))
        BUILDERS[fmt](root / "corpus", rng)
        out[fmt] = root
    return out


def _quiet(fn, *a, **kw):
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn(*a, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("fmt", FORMATS)
def test_create_and_split_bytes_equal_jax(corpora, fmt):
    from libreasr_tpu.data.create_dataset import create_dataset as jax_create
    from libreasr_tpu.data.split import split_dataset as jax_split

    if fmt not in corpora:
        pytest.skip("host has no libmpg123/libmp3lame")
    root = corpora[fmt]
    corpus = str(root / "corpus")
    outs = {}
    for name, create, split in (("jax", jax_create, jax_split),
                                ("port", create_dataset, split_dataset)):
        d = root / name
        d.mkdir()
        csv = str(d / "asr-dataset.csv")
        _quiet(create, corpus, fmt, workers=2, out=csv, pool="thread")
        _quiet(split, str(d), valid=0.3, test=0.2, seed=7)
        outs[name] = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}
    assert sorted(outs["port"]) == [
        "asr-dataset-test.csv", "asr-dataset-train.csv", "asr-dataset-valid.csv",
        "asr-dataset.csv"]
    for f in outs["jax"]:
        assert outs["port"][f] == outs["jax"][f], f
    lines = outs["port"]["asr-dataset.csv"].decode().splitlines()
    assert len(lines) > 2 and "\r" not in outs["port"]["asr-dataset.csv"].decode()


def test_rows_cover_the_formats(corpora):
    """What the parity corpora exercise: a bad row, an unlabeled row,
    float durations, yt cue rows, pandas' missing-value spelling."""
    import csv

    def rows(fmt):
        d = corpora[fmt] / "port"
        with open(d / "asr-dataset.csv", newline="") as f:
            return list(csv.DictReader(f))

    libri = rows("librispeech")
    assert sum(r["bad"] == "True" for r in libri) == 2  # undecodable, unlabeled
    assert {r["xlen"] for r in libri if "0099" in r["file"]} == {"0.0"}
    assert any(r["label"] == "on the mat" for r in libri)
    assert any(r["label"] == "speech is fun" for r in libri)
    yt = rows("yt")
    assert [(r["xstart"], r["xlen"], r["label"]) for r in yt] == [
        ("500", "750", "hello there"), ("1300", "1600", "second cue two lines"),
        ("3000", "100", "music")]
    tf = rows("tf-speech")
    assert {r["label"] for r in tf} == {"yes", "no", "background noise"}
    tat = rows("tatoeba")
    assert sorted(r["label"] for r in tat) == ["it's late", "ok", "tom is here"]
    if "common-voice" in corpora:
        cv = rows("common-voice")
        assert sorted(r["label"] for r in cv) == [
            "common voice one", "nan", "nan", "quoted she said"]


def test_parse_vtt_matches_jax(tmp_path):
    from libreasr_tpu.data.create_dataset import parse_vtt as jax_parse

    p = tmp_path / "a.vtt"
    p.write_text(
        "WEBVTT\n\n1\n00:00:01.000 --> 00:00:02.500 align:start\nHello <i>there</i>\n\n"
        "01:00:00,000 --> 01:00:03,000\nSecond cue\ntwo lines\n\nNOTE x\n")
    assert parse_vtt(str(p)) == jax_parse(str(p))
    assert parse_vtt(str(p))[0] == (1000, 2500, "hello there")


@pytest.fixture(scope="module")
def libri(corpora):
    return str(corpora["librispeech"] / "corpus")


def test_crash_resume_gives_the_full_bytes(libri, tmp_path):
    """An interrupted run, its partial CSV torn mid-line, resumes to the
    bytes of an uninterrupted run (the JAX package's test_data case), and
    the port's resumed CSV equals JAX's resumed CSV."""
    from libreasr_tpu.data.create_dataset import create_dataset as jax_create

    full = str(tmp_path / "full.csv")
    _quiet(create_dataset, libri, "librispeech", workers=2, out=full,
           pool="thread", flush_every=2)
    want = open(full, "rb").read()
    lines = open(full).read().splitlines(keepends=True)
    torn = lines[: 1 + 4] + [lines[5][: len(lines[5]) // 2]]
    for name, create in (("port", create_dataset), ("jax", jax_create)):
        out = str(tmp_path / f"resumed_{name}.csv")
        open(out + ".partial", "w").write("".join(torn))
        printed = _quiet(create, libri, "librispeech", workers=2, out=out,
                         pool="thread", flush_every=2)
        assert "resuming: 3/" in printed
        assert open(out, "rb").read() == want
        assert not os.path.exists(out + ".partial")


def test_partial_with_another_header_is_ignored(libri, tmp_path):
    out = str(tmp_path / "x.csv")
    open(out + ".partial", "w").write("a,b\n1,2\n")
    printed = _quiet(create_dataset, libri, "librispeech", workers=1, out=out,
                     pool="thread")
    assert "resuming" not in printed
    ref = str(tmp_path / "ref.csv")
    _quiet(create_dataset, libri, "librispeech", workers=1, out=ref, pool="thread")
    assert open(out, "rb").read() == open(ref, "rb").read()


def test_process_pool_equals_thread_pool(libri, tmp_path):
    a, b = str(tmp_path / "proc.csv"), str(tmp_path / "thr.csv")
    _quiet(create_dataset, libri, "librispeech", workers=2, out=a, pool="process")
    _quiet(create_dataset, libri, "librispeech", workers=2, out=b, pool="thread")
    assert open(a, "rb").read() == open(b, "rb").read()


def test_split_reads_jax_csv_and_jax_reads_ports(libri, tmp_path):
    """Each package's split of the other's CSV gives the same parts."""
    from libreasr_tpu.data.builder import ASRDatasetBuilder as JaxBuilder
    from libreasr_tpu.data.split import split_dataset as jax_split
    from libreasr_tpu_torch.data.builder import ASRDatasetBuilder

    d = tmp_path / "d"
    d.mkdir()
    _quiet(create_dataset, libri, "librispeech", workers=1,
           out=str(d / "asr-dataset.csv"), pool="thread")
    _quiet(split_dataset, str(d), valid=0.25, test=0.0)
    port_parts = {f: (d / f).read_bytes() for f in os.listdir(d)}
    _quiet(jax_split, str(d), valid=0.25, test=0.0)
    assert {f: (d / f).read_bytes() for f in os.listdir(d)} == port_parts
    conf = {"datasets": ["c"], "dataset_paths": {"c": str(d)},
            "apply_limits": True, "almins": 0.1, "almaxs": 6.0,
            "pcent": {"train": 1.0}, "shuffle_builder": {"train": False}}
    jb = JaxBuilder.from_config(conf, "train")
    pb = ASRDatasetBuilder.from_config(conf, "train")
    assert [r["file"] for r in pb.rows] == list(jb.df["file"])
    assert pb.stats() == jb.stats()


def _inspect_conf(corpus_dir):
    return {
        "datasets": ["c"], "dataset_paths": {"c": corpus_dir},
        "apply_limits": True, "almins": 0.1, "almaxs": 6.0,
        "pcent": {"train": 1.0}, "shuffle_builder": {"train": False},
        "sr": 16000, "seed": 0, "shuffle": False,
        "transforms": {
            "x": [{"name": "OpenAudio"}, {"name": "ChannelCut"},
                  {"name": "Resample"}, {"name": "PadderCutter"}],
            "y": [{"name": "OpenLabel"}, {"name": "PadCutLabel"},
                  {"name": "Numericalize"}, {"name": "AddLen"}],
        },
        "buckets": [{"max_samples": 24000, "y_max": 24, "bs": 2},
                    {"max_samples": 48000, "y_max": 24, "bs": 2}],
    }


def test_inspect_equals_jax(libri, tmp_path):
    from libreasr_tpu.data import inspect as jax_inspect
    from libreasr_tpu.data.batching import ASRDataset as JaxDataset
    from libreasr_tpu.data.language import get_language as jax_language
    from libreasr_tpu_torch.data import inspect as port_inspect
    from libreasr_tpu_torch.data.batching import ASRDataset
    from libreasr_tpu_torch.data.language import get_language

    d = tmp_path / "d"
    d.mkdir()
    _quiet(create_dataset, libri, "librispeech", workers=1,
           out=str(d / "asr-dataset.csv"), pool="thread")
    conf = _inspect_conf(str(d))
    jds = JaxDataset.from_config(conf, jax_language()[0], "train")
    pds = ASRDataset.from_config(conf, get_language()[0], "train")
    got = port_inspect.pipeline_statistics(pds, n_items=16)
    assert got == jax_inspect.pipeline_statistics(jds, n_items=16)
    assert got["items"] == 6  # the good rows
    got = port_inspect.batch_statistics(pds)
    assert got == jax_inspect.batch_statistics(jds) and got
    got = port_inspect.augmentation_preview(pds, 1)
    assert got == jax_inspect.augmentation_preview(jds, 1)
    assert got["changed"] is False and pds.pipeline.training


def test_cli_writes_the_module_bytes(libri, tmp_path):
    from libreasr_tpu_torch.data import create_dataset as cd
    from libreasr_tpu_torch.data import split as sp

    d = tmp_path / "cli"
    d.mkdir()
    _quiet(cd.main, [libri, "--format", "librispeech", "--workers", "1",
                     "--pool", "thread", "--out", str(d / "asr-dataset.csv")])
    ref = tmp_path / "ref.csv"
    _quiet(create_dataset, libri, "librispeech", workers=1, out=str(ref),
           pool="thread")
    assert (d / "asr-dataset.csv").read_bytes() == ref.read_bytes()
    printed = _quiet(sp.main, [str(d), "--valid", "0.4", "--test", "0.2"])
    assert "train:" in printed and (d / "asr-dataset-valid.csv").exists()
    shutil.rmtree(d)
