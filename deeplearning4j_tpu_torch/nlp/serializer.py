"""Word-vector persistence.

Parity surface: reference ``models/embeddings/loader/WordVectorSerializer.java``
— the word2vec *text* format (``V D`` header then ``word v1 … vD`` lines,
readable by gensim/fastText) and the *Google binary* format
(``V D\\n`` ASCII header then ``word`` + space + D little-endian float32 per
word), plus full-model save/restore.

Host-side IO only; matrices are plain numpy. The JAX package's
``nlp/serializer.py`` on PyTorch: the same three formats, so files cross
between the packages both ways; a restored model's tables go to
``device``."""

from __future__ import annotations

import io
import json
import zipfile
from typing import List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.vocab import (AbstractCache, VocabWord, build_huffman,
                                                unigram_table)
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec


class StaticWordVectors:
    """Lookup-only word vectors as returned by the readers (reference
    WordVectors interface: getWordVectorMatrix/similarity/wordsNearest)."""

    def __init__(self, vocab: AbstractCache, matrix: np.ndarray):
        self.vocab = vocab
        self.syn0 = np.asarray(matrix, np.float32)

    def has_word(self, word: str) -> bool:
        return self.vocab.contains_word(word)

    def word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        return None if i < 0 else self.syn0[i]

    def get_word_vector_matrix(self) -> np.ndarray:
        return self.syn0

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.word_vector(a), self.word_vector(b)
        if va is None or vb is None:
            return float("nan")
        denom = (np.linalg.norm(va) * np.linalg.norm(vb)) or 1e-12
        return float(va @ vb / denom)

    def words_nearest(self, word_or_vec, top_n: int = 10) -> List[str]:
        if isinstance(word_or_vec, str):
            v = self.word_vector(word_or_vec)
            exclude = {word_or_vec}
        else:
            v = np.asarray(word_or_vec, np.float32)
            exclude = set()
        if v is None:
            return []
        norms = np.linalg.norm(self.syn0, axis=1) * (np.linalg.norm(v) or 1e-12)
        sims = (self.syn0 @ v) / np.maximum(norms, 1e-12)
        out = []
        for i in np.argsort(-sims):
            w = self.vocab.word_at_index(int(i))
            if w not in exclude:
                out.append(w)
            if len(out) >= top_n:
                break
        return out


def _model_vocab_matrix(model_or_pair) -> Tuple[AbstractCache, np.ndarray]:
    if isinstance(model_or_pair, tuple):
        vocab, matrix = model_or_pair
    else:
        vocab = model_or_pair.vocab
        matrix = model_or_pair.get_word_vector_matrix()
    return vocab, _host(matrix)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def _vocab_from_words(words: List[str], counts: Optional[List[int]] = None
                      ) -> AbstractCache:
    """Rebuild a cache preserving the on-disk word order (readers must not
    re-sort — the matrix rows are positional)."""
    cache = AbstractCache()
    for i, w in enumerate(words):
        vw = VocabWord(w, counts[i] if counts else 1)
        vw.index = i
        cache._words[w] = vw
        cache._by_index.append(vw)
    cache.total_word_occurrences = sum(v.count for v in cache._by_index)
    return cache


class WordVectorSerializer:
    """Static façade mirroring the reference's WordVectorSerializer."""

    # ----------------------------------------------------------- text format
    @staticmethod
    def write_word_vectors(model, path: str):
        """word2vec text format (reference writeWordVectors)."""
        vocab, matrix = _model_vocab_matrix(model)
        with open(path, "w", encoding="utf-8") as f:
            f.write(f"{len(matrix)} {matrix.shape[1]}\n")
            for i in range(len(matrix)):
                word = vocab.word_at_index(i)
                vec = " ".join(f"{x:.6g}" for x in matrix[i])
                f.write(f"{word} {vec}\n")

    @staticmethod
    def read_word_vectors(path: str) -> StaticWordVectors:
        """Read the text format; tolerates a missing header line (reference
        loadTxtVectors sniffs for it)."""
        words: List[str] = []
        rows: List[np.ndarray] = []
        with open(path, "r", encoding="utf-8") as f:
            first = f.readline().rstrip("\n")
            parts = first.split()
            if len(parts) != 2 or not all(p.isdigit() for p in parts):
                words.append(parts[0])
                rows.append(np.asarray([float(x) for x in parts[1:]], np.float32))
            for line in f:
                parts = line.rstrip("\n").split()
                if not parts:
                    continue
                words.append(parts[0])
                rows.append(np.asarray([float(x) for x in parts[1:]], np.float32))
        return StaticWordVectors(_vocab_from_words(words), np.stack(rows))

    # --------------------------------------------------------- binary format
    @staticmethod
    def write_word2vec_binary(model, path: str):
        """Google word2vec binary format (reference writeWordVectors binary
        branch / loadGoogleModel's inverse)."""
        vocab, matrix = _model_vocab_matrix(model)
        with open(path, "wb") as f:
            f.write(f"{len(matrix)} {matrix.shape[1]}\n".encode())
            for i in range(len(matrix)):
                f.write(vocab.word_at_index(i).encode("utf-8") + b" ")
                f.write(matrix[i].astype("<f4").tobytes())
                f.write(b"\n")

    @staticmethod
    def read_word2vec_binary(path: str) -> StaticWordVectors:
        with open(path, "rb") as f:
            header = f.readline().decode("utf-8").split()
            v, d = int(header[0]), int(header[1])
            words, rows = [], []
            for _ in range(v):
                chars = bytearray()
                while True:
                    ch = f.read(1)
                    if not ch or ch == b" ":
                        break
                    if ch != b"\n":       # leading newline from previous row
                        chars.extend(ch)
                words.append(chars.decode("utf-8"))
                rows.append(np.frombuffer(f.read(4 * d), "<f4").copy())
        return StaticWordVectors(_vocab_from_words(words), np.stack(rows))

    # ------------------------------------------------------------ full model
    @staticmethod
    def write_word2vec_model(model, path: str):
        """Full-model zip (reference writeWord2VecModel: config + syn0 + syn1
        + vocab frequencies), restorable for continued training."""
        vocab, _ = _model_vocab_matrix(model)
        config = {
            "layer_size": model.layer_size, "window_size": model.window_size,
            "negative": model.negative, "learning_rate": model.learning_rate,
            "min_learning_rate": model.min_learning_rate,
            "sampling": model.sampling, "epochs": model.epochs,
            "min_word_frequency": model.min_word_frequency,
            "use_cbow": model.use_cbow, "seed": model.seed,
        }
        vocab_rows = [{"word": vw.word, "count": vw.count}
                      for vw in vocab.vocab_words()]
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("config.json", json.dumps(config))
            z.writestr("vocab.json", json.dumps(vocab_rows))
            for name, arr in (("syn0", model.syn0), ("syn1", model.syn1)):
                buf = io.BytesIO()
                np.save(buf, _host(arr))
                z.writestr(name + ".npy", buf.getvalue())

    @staticmethod
    def read_word2vec_model(path: str, device=None):
        """The zip's model as a port ``Word2Vec`` with its tables on
        ``device`` (``cuda`` unless ``"cpu"`` is passed)."""
        with zipfile.ZipFile(path, "r") as z:
            config = json.loads(z.read("config.json"))
            vocab_rows = json.loads(z.read("vocab.json"))
            syn0 = np.load(io.BytesIO(z.read("syn0.npy")))
            syn1 = np.load(io.BytesIO(z.read("syn1.npy")))
        return restore_word2vec(config, [r["word"] for r in vocab_rows],
                                [r["count"] for r in vocab_rows], syn0, syn1, device)


def restore_word2vec(config, words, counts, syn0, syn1, device=None):
    """A ``Word2Vec`` from its constructor keywords, vocab words in index
    order with their counts, and (V, D) ``syn0`` / ``syn1`` arrays; the
    tables go to ``device`` and the derived tables the steps need
    (Huffman codes, unigram table) are rebuilt."""
    model = Word2Vec(**config, device=device)
    model.vocab = _vocab_from_words(list(words), [int(c) for c in counts])
    model.syn0 = model._tensor(np.asarray(syn0, np.float32))
    model.syn1 = model._tensor(np.asarray(syn1, np.float32))
    if model.use_hs:
        model._codes, model._points, model._lengths = build_huffman(model.vocab)
    if model.negative > 0:
        model._neg_table = unigram_table(model.vocab)
    return model
