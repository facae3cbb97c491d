"""``org.deeplearning4j.models.embeddings.loader.WordVectorSerializer``:
the classic text format (`word v1 v2 ...` with an optional `V D` header
line, the word2vec.c / GloVe interchange format).  Port of
``deeplearning4j_tpu/nlp/serializer.py``: the same code, host only."""
from __future__ import annotations


import numpy as np


class WordVectorSerializer:
    @staticmethod
    def write_word_vectors(model, path: str, header: bool = True):
        with open(path, "w") as f:
            if header:
                f.write(f"{len(model.index2word)} {model.vector_size}\n")
            for w in model.index2word:
                vec = " ".join(f"{v:.6f}" for v in model.get_word_vector(w))
                f.write(f"{w} {vec}\n")

    @staticmethod
    def read_word_vectors(path: str):
        """Returns a lookup-only model (vocab + syn0; not trainable)."""
        from deeplearning4j_torch.nlp.word2vec import Word2Vec
        words, vecs = [], []
        with open(path) as f:
            first = f.readline().split()
            if len(first) == 2 and all(p.isdigit() for p in first):
                pass  # header consumed
            else:
                words.append(first[0])
                vecs.append([float(v) for v in first[1:]])
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if len(parts) < 2:
                    continue
                words.append(parts[0])
                vecs.append([float(v) for v in parts[1:]])
        arr = np.asarray(vecs, np.float32)
        model = Word2Vec(vector_size=arr.shape[1])
        model.index2word = words
        model.vocab = {w: i for i, w in enumerate(words)}
        model.syn0 = arr
        return model
