"""Text dataset zoo (counterpart of paddle_tpu/text/datasets.py, after
python/paddle/text/datasets/ — imdb.py, imikolov.py, uci_housing.py).

No downloads: each dataset parses the SAME local archive the reference
downloads (URL + md5 documented per class so an operator can stage it);
a missing file falls back to deterministic synthetic samples with a LOUD
warning, or raises with allow_synthetic=False — never silently, the
reference's rule (:24). Samples are numpy arrays, as the reference's
are; a DataLoader collates them onto the device it is asked for."""
from __future__ import annotations

import os
import re
import string
import tarfile
import warnings

import numpy as np

from ..io import Dataset

__all__ = ["Imdb", "Imikolov", "UCIHousing"]


def _synthetic_fallback(name: str, reason: str, allow: bool):
    msg = (f"{name}: {reason} — falling back to DETERMINISTIC SYNTHETIC "
           f"samples. This is NOT the real dataset; stage the documented "
           f"archive locally (zero-egress: no downloads), or pass "
           f"allow_synthetic=False to make this an error.")
    if not allow:
        raise FileNotFoundError(f"{name}: {reason} (allow_synthetic=False)")
    warnings.warn(msg, UserWarning, stacklevel=3)


class Imdb(Dataset):
    """IMDB sentiment (ref: python/paddle/text/datasets/imdb.py —
    URL https://dataset.bj.bcebos.com/imdb%2FaclImdb_v1.tar.gz,
    md5 7c2ac02c03563afcf9b574c7e56c153a).

    data_file: local aclImdb_v1.tar.gz. Samples are (word-id int64
    array, label) with label 0 = pos, 1 = neg (reference convention);
    the word dict is built from the TRAIN split with frequency > cutoff,
    '<unk>' mapped to len(dict)."""

    def __init__(self, data_file=None, mode="train", cutoff=150,
                 allow_synthetic=True):
        assert mode in ("train", "test"), mode
        self.mode = mode
        if data_file and os.path.exists(data_file):
            self._load(data_file, cutoff)
        else:
            _synthetic_fallback(
                "Imdb", "no local aclImdb_v1.tar.gz" if not data_file
                else f"data_file {data_file!r} does not exist",
                allow_synthetic)
            rng = np.random.RandomState(0 if mode == "train" else 1)
            self.word_idx = {w: i for i, w in enumerate(
                string.ascii_lowercase)}
            self.word_idx["<unk>"] = len(self.word_idx)
            self.docs = [rng.randint(0, 26, size=rng.randint(5, 40))
                         .astype(np.int64) for _ in range(128)]
            self.labels = rng.randint(0, 2, size=128).astype(np.int64)

    def _tokenize(self, text):
        return re.sub(r"[^a-z\s]", "", text.lower()).split()

    def _load(self, data_file, cutoff):
        pat = re.compile(
            rf"aclImdb/{self.mode}/(pos|neg)/.*\.txt$")
        train_pat = re.compile(r"aclImdb/train/(pos|neg)/.*\.txt$")
        freq: dict = {}
        docs_raw, labels = [], []
        with tarfile.open(data_file) as tf:
            for m in tf:
                if not m.isfile():
                    continue
                is_train = bool(train_pat.match(m.name))
                mm = pat.match(m.name)
                if not (is_train or mm):
                    continue
                words = self._tokenize(
                    tf.extractfile(m).read().decode("utf-8", "ignore"))
                if is_train:
                    for w in words:
                        freq[w] = freq.get(w, 0) + 1
                if mm:
                    docs_raw.append(words)
                    labels.append(0 if mm.group(1) == "pos" else 1)
        # dict: train words with freq > cutoff, rank-ordered (ref
        # build_dict), '<unk>' = len(dict)
        kept = sorted((w for w, c in freq.items() if c > cutoff),
                      key=lambda w: (-freq[w], w))
        self.word_idx = {w: i for i, w in enumerate(kept)}
        unk = self.word_idx["<unk>"] = len(self.word_idx)
        self.docs = [np.asarray([self.word_idx.get(w, unk) for w in d],
                                np.int64) for d in docs_raw]
        self.labels = np.asarray(labels, np.int64)

    def __getitem__(self, idx):
        return self.docs[idx], int(self.labels[idx])

    def __len__(self):
        return len(self.docs)


class Imikolov(Dataset):
    """PTB language-model dataset (ref:
    python/paddle/text/datasets/imikolov.py — URL
    https://dataset.bj.bcebos.com/imikolov%2Fsimple-examples.tgz,
    md5 30177ea32e27c525793142b6bf2c8e2d).

    data_type='NGRAM' yields window_size-gram id tuples; 'SEQ' yields
    (input ids, shifted target ids). Dict from the train split with
    freq >= min_word_freq plus '<s>', '<e>', '<unk>'."""

    def __init__(self, data_file=None, data_type="NGRAM", window_size=5,
                 mode="train", min_word_freq=50, allow_synthetic=True):
        assert mode in ("train", "test"), mode
        assert data_type in ("NGRAM", "SEQ"), data_type
        self.data_type = data_type
        self.window_size = window_size
        if data_file and os.path.exists(data_file):
            lines_tr = self._read(data_file, "ptb.train.txt")
            lines = lines_tr if mode == "train" else self._read(
                data_file, "ptb.valid.txt")
        else:
            _synthetic_fallback(
                "Imikolov", "no local simple-examples.tgz"
                if not data_file
                else f"data_file {data_file!r} does not exist",
                allow_synthetic)
            rng = np.random.RandomState(0)
            vocab = [f"w{i}" for i in range(40)]
            lines_tr = [[vocab[j] for j in rng.randint(0, 40, 12)]
                        for _ in range(64)]
            lines = lines_tr if mode == "train" else lines_tr[:16]
        freq: dict = {}
        for ws in lines_tr:
            for w in ws:
                freq[w] = freq.get(w, 0) + 1
        kept = sorted((w for w, c in freq.items()
                       if c >= min_word_freq and w != "<unk>"),
                      key=lambda w: (-freq[w], w))
        self.word_idx = {w: i for i, w in enumerate(kept)}
        for tok in ("<s>", "<e>", "<unk>"):
            self.word_idx.setdefault(tok, len(self.word_idx))
        unk = self.word_idx["<unk>"]
        self.data = []
        for ws in lines:
            ids = ([self.word_idx["<s>"]]
                   + [self.word_idx.get(w, unk) for w in ws]
                   + [self.word_idx["<e>"]])
            if data_type == "NGRAM":
                if len(ids) >= window_size:
                    for i in range(window_size, len(ids) + 1):
                        self.data.append(np.asarray(
                            ids[i - window_size:i], np.int64))
            else:
                self.data.append((np.asarray(ids[:-1], np.int64),
                                  np.asarray(ids[1:], np.int64)))

    @staticmethod
    def _read(data_file, member_suffix):
        with tarfile.open(data_file) as tf:
            for m in tf:
                if m.name.endswith(member_suffix):
                    raw = tf.extractfile(m).read().decode(
                        "utf-8", "ignore")
                    return [ln.strip().split() for ln in raw.splitlines()
                            if ln.strip()]
        raise ValueError(f"{member_suffix} not found in {data_file}")

    def __getitem__(self, idx):
        return self.data[idx]

    def __len__(self):
        return len(self.data)


class UCIHousing(Dataset):
    """Boston housing regression (ref:
    python/paddle/text/datasets/uci_housing.py — URL
    http://paddlemodels.bj.bcebos.com/uci_housing/housing.data,
    md5 d4accdce7a25600298819f8e28e8d593).

    506 rows x 14 columns; features min-max-centred over the whole file
    (reference normalization), train = first 404 rows, test = rest."""

    TRAIN_ROWS = 404

    def __init__(self, data_file=None, mode="train",
                 allow_synthetic=True):
        assert mode in ("train", "test"), mode
        if data_file and os.path.exists(data_file):
            raw = np.loadtxt(data_file).astype(np.float32)
        else:
            _synthetic_fallback(
                "UCIHousing", "no local housing.data" if not data_file
                else f"data_file {data_file!r} does not exist",
                allow_synthetic)
            rng = np.random.RandomState(0)
            raw = rng.standard_normal((506, 14)).astype(np.float32)
        if raw.ndim != 2 or raw.shape[1] != 14:
            raise ValueError(
                f"housing.data must be [N, 14]; got {raw.shape}")
        feats = raw[:, :13]
        maxs, mins, avgs = feats.max(0), feats.min(0), feats.mean(0)
        feats = (feats - avgs) / np.maximum(maxs - mins, 1e-6)
        data = np.concatenate([feats, raw[:, 13:]], axis=1)
        self.data = (data[:self.TRAIN_ROWS] if mode == "train"
                     else data[self.TRAIN_ROWS:])

    def __getitem__(self, idx):
        row = self.data[idx]
        return row[:13], row[13:]

    def __len__(self):
        return len(self.data)
