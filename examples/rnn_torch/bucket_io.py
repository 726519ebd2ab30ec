"""Bucketed sentence iterator for LM training.

Mirrors the reference example/rnn/bucket_io.py: tokenize a corpus, assign
each sentence to the smallest bucket that fits, emit DataBatch with
bucket_key so BucketingModule / FeedForward(sym_gen) pick the right
executor. Synthetic corpus fallback for air-gapped runs.

The copy of examples/rnn/bucket_io.py for mxnet_tpu_torch: only the
imports differ. Batches are made on the current context.
"""
import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.io import DataBatch, DataDesc, DataIter


def default_build_vocab(path):
    """path -> {word: id}; id 0 reserved for padding (ref bucket_io.py:20)."""
    content = open(path).read()
    content = content.replace('\n', ' <eos> ').split(' ')
    words = sorted(set(content))
    vocab = {}
    idx = 1  # 0 is padding
    for word in words:
        if len(word) == 0:
            continue
        vocab[word] = idx
        idx += 1
    return vocab


def default_text2id(sentence, vocab):
    words = [vocab[w] for w in sentence.split(' ') if len(w) > 0]
    return words


def synthetic_corpus(num_sentences=2000, vocab_size=200, seed=0):
    """Markov-chain synthetic corpus: learnable bigram structure."""
    rng = np.random.RandomState(seed)
    trans = rng.dirichlet(np.ones(vocab_size) * 0.05, size=vocab_size)
    sents = []
    for _ in range(num_sentences):
        n = rng.randint(5, 60)
        w = rng.randint(1, vocab_size)
        sent = [w]
        for _ in range(n - 1):
            w = rng.choice(vocab_size, p=trans[w])
            sent.append(max(1, w))
        sents.append(sent)
    return sents


class BucketSentenceIter(DataIter):
    """(ref: example/rnn/bucket_io.py:57 BucketSentenceIter)."""

    def __init__(self, path, vocab, buckets, batch_size,
                 init_states, data_name='data', label_name='softmax_label',
                 text2id=None, read_content=None, model_parallel=False,
                 sentences=None, seed=0):
        super().__init__()
        if sentences is None:
            content = open(path).read() if path else None
            if content is not None:
                vocab = vocab or default_build_vocab(path)
                text2id = text2id or default_text2id
                sentences = [text2id(s, vocab)
                             for s in content.replace('\n', ' <eos> ').split(' <eos> ')]
            else:
                sentences = synthetic_corpus(seed=seed)
        self.vocab_size = (max(vocab.values()) + 1) if vocab else (
            max(max(s) for s in sentences if s) + 1)
        buckets = sorted(buckets)
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.model_parallel = model_parallel

        # bucket the sentences (pad with 0 on the right)
        self.data = [[] for _ in buckets]
        for sent in sentences:
            if len(sent) == 0:
                continue
            for i, bkt in enumerate(buckets):
                if bkt >= len(sent):
                    self.data[i].append(sent)
                    break
            # sentences longer than the largest bucket are discarded


        self.batch_size = batch_size
        self.init_states = init_states
        self.init_state_arrays = [np.zeros(s, dtype='float32') for _, s in init_states]
        self.default_bucket_key = max(buckets)

        self._make_batches(seed)
        self.reset()

    def _make_batches(self, seed):
        rng = np.random.RandomState(seed)
        self.batches = []
        for i, bkt in enumerate(self.buckets):
            sents = self.data[i]
            rng.shuffle(sents)
            for start in range(0, len(sents) - self.batch_size + 1, self.batch_size):
                chunk = sents[start:start + self.batch_size]
                d = np.zeros((self.batch_size, bkt), dtype='float32')
                l = np.zeros((self.batch_size, bkt), dtype='float32')
                for j, sent in enumerate(chunk):
                    d[j, :len(sent)] = sent
                    l[j, :len(sent) - 1] = sent[1:]
                self.batches.append((bkt, d, l))

    @property
    def provide_data(self):
        return ([DataDesc(self.data_name, (self.batch_size, self.default_bucket_key))]
                + [DataDesc(n, s) for n, s in self.init_states])

    @property
    def provide_label(self):
        return [DataDesc(self.label_name, (self.batch_size, self.default_bucket_key))]

    def reset(self):
        self.cur = 0
        np.random.shuffle(self.batches)

    def next(self):
        if self.cur >= len(self.batches):
            raise StopIteration
        bkt, d, l = self.batches[self.cur]
        self.cur += 1
        data = [mx.nd.array(d)] + [mx.nd.array(x) for x in self.init_state_arrays]
        label = [mx.nd.array(l)]
        return DataBatch(
            data=data, label=label, bucket_key=bkt,
            provide_data=([DataDesc(self.data_name, (self.batch_size, bkt))]
                          + [DataDesc(n, s) for n, s in self.init_states]),
            provide_label=[DataDesc(self.label_name, (self.batch_size, bkt))],
        )
