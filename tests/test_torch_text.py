"""paddle_tpu_torch.text against paddle_tpu.text: ViterbiDecoder on the
same numpy potentials, transitions and lengths (scores within 1e-5, f32
sums in other orders; paths exactly), and the dataset zoo on the same
local archives (small ones written here in the reference's layouts) and
on its synthetic fallback: samples exactly equal."""
import io
import tarfile

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import text as jtext
from paddle_tpu_torch import text as ttext
from torch_port_helpers import cpu_place


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_place():
        yield


@pytest.mark.parametrize("bos_eos", [True, False])
def test_viterbi_decoder_equals_the_reference(bos_eos):
    rng = np.random.default_rng(0)
    pots = rng.standard_normal((3, 6, 5)).astype(np.float32)
    trans = rng.standard_normal((5, 5)).astype(np.float32)
    lens = np.array([6, 3, 1], np.int64)
    out = {}
    for name, P, T in (("ref", pt, jtext), ("port", ptt, ttext)):
        dec = T.ViterbiDecoder(P.to_tensor(trans), include_bos_eos_tag=bos_eos)
        scores, paths = dec(P.to_tensor(pots), P.to_tensor(lens))
        out[name] = (scores.numpy(), paths.numpy())
    np.testing.assert_allclose(out["port"][0], out["ref"][0], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(out["port"][1], out["ref"][1])
    assert out["port"][1].dtype == out["ref"][1].dtype


def _add(tf, name, text):
    data = text.encode()
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


@pytest.fixture
def archives(tmp_path):
    rng = np.random.default_rng(1)
    words = ["good", "bad", "film", "plot", "actor", "dull", "great"]
    imdb = tmp_path / "aclImdb_v1.tar.gz"
    with tarfile.open(imdb, "w:gz") as tf:
        for split in ("train", "test"):
            for label in ("pos", "neg"):
                for i in range(4):
                    _add(tf, f"aclImdb/{split}/{label}/{i}.txt", " ".join(
                        rng.choice(words, 12)) + "! It's <br/> fine.")
    ptb = tmp_path / "simple-examples.tgz"
    with tarfile.open(ptb, "w:gz") as tf:
        for split, n in (("train", 30), ("valid", 8)):
            _add(tf, f"simple-examples/data/ptb.{split}.txt", "\n".join(
                " ".join(rng.choice(words, 7)) for _ in range(n)))
    housing = tmp_path / "housing.data"
    np.savetxt(housing, rng.standard_normal((506, 14)))
    return dict(imdb=str(imdb), ptb=str(ptb), housing=str(housing))


def _samples(ds):
    out = []
    for i in range(len(ds)):
        s = ds[i]
        out.append(tuple(np.asarray(x) for x in s) if isinstance(s, tuple)
                   else (np.asarray(s),))
    return out


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
            assert u.dtype == v.dtype


CASES = {
    "imdb_train": ("Imdb", "imdb", dict(mode="train", cutoff=3)),
    "imdb_test": ("Imdb", "imdb", dict(mode="test", cutoff=3)),
    "imikolov_ngram": ("Imikolov", "ptb", dict(window_size=3,
                                               min_word_freq=5)),
    "imikolov_seq": ("Imikolov", "ptb", dict(data_type="SEQ", mode="test",
                                             min_word_freq=5)),
    "uci_train": ("UCIHousing", "housing", dict(mode="train")),
    "uci_test": ("UCIHousing", "housing", dict(mode="test")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_datasets_parse_the_local_archives_as_the_reference(case, archives):
    cls, key, kw = CASES[case]
    want = getattr(jtext, cls)(data_file=archives[key], **kw)
    got = getattr(ttext, cls)(data_file=archives[key], **kw)
    _equal(_samples(got), _samples(want))
    if hasattr(want, "word_idx"):
        assert got.word_idx == want.word_idx


@pytest.mark.parametrize("cls", ["Imdb", "Imikolov", "UCIHousing"])
def test_synthetic_fallback_warns_and_equals_the_reference(cls):
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        want = getattr(jtext, cls)()
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        got = getattr(ttext, cls)()
    _equal(_samples(got), _samples(want))
    with pytest.raises(FileNotFoundError, match="allow_synthetic=False"):
        getattr(ttext, cls)(data_file="/nonexistent/x",
                            allow_synthetic=False)


def test_a_loader_takes_the_samples():
    with pytest.warns(UserWarning):
        ds = ttext.UCIHousing(mode="test")
    x, y = next(iter(ptt.io.DataLoader(ds, batch_size=8)))
    assert tuple(x.shape) == (8, 13) and tuple(y.shape) == (8, 1)
