"""TIGER data utilities: semantic-id remapping and trie-constrained decoding.

The port's own copy of ``torch_rechub_tpu/utils/tiger.py`` (pure Python):
map items to semantic-id token sequences (``semantic_id_vocab``), build
(input, label) pairs from interaction histories (``build_tiger_samples``),
and a prefix ``Trie`` over the valid codes for ``generate``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


class Trie:
    """Prefix trie over token sequences; ``allowed_next(prefix)`` for decoding."""

    def __init__(self, sequences: Sequence[Sequence[int]] = ()):
        self.root: Dict = {}
        for seq in sequences:
            self.insert(seq)

    def insert(self, seq: Sequence[int]):
        node = self.root
        for tok in seq:
            node = node.setdefault(int(tok), {})

    def allowed_next(self, prefix: Sequence[int]) -> List[int]:
        node = self.root
        for tok in prefix:
            node = node.get(int(tok))
            if node is None:
                return []
        return list(node.keys())

    def __contains__(self, seq: Sequence[int]) -> bool:
        node = self.root
        for tok in seq:
            node = node.get(int(tok))
            if node is None:
                return False
        return True


def semantic_id_vocab(indices_dict: Dict[int, List[str]], n_special: int = 2) -> Tuple[Dict[str, int], Dict[int, List[int]]]:
    """Build a token vocabulary from semantic-id code strings.

    Args:
        indices_dict: ``{item: ["<a_3>", "<b_17>", ...]}`` from
            ``RQVAETrainer.generate_semantic_ids``.
        n_special: reserved low token ids (0=PAD, 1=EOS by convention).

    Returns:
        (token->id mapping, item->token-id-sequence mapping).
    """
    vocab: Dict[str, int] = {}
    item_tokens: Dict[int, List[int]] = {}
    for item, codes in indices_dict.items():
        toks = []
        for code in codes:
            if code not in vocab:
                vocab[code] = len(vocab) + n_special
            toks.append(vocab[code])
        item_tokens[item] = toks
    return vocab, item_tokens


def build_tiger_samples(histories: Dict[int, List[int]], item_tokens: Dict[int, List[int]], max_his_len: int = 20, eos_token_id: int = 1):
    """Leave-one-out (input_ids, labels) pairs over semantic-id tokens.

    For each user: input = flattened codes of the history (truncated to the
    last ``max_his_len`` items), label = target item's codes + EOS.
    Returns (train_inputs, train_labels, test_inputs, test_labels) as ragged
    python lists (pad with ``pad_sequences`` downstream).
    """
    train_x, train_y, test_x, test_y = [], [], [], []
    for user, items in histories.items():
        if len(items) < 3:
            continue
        for i in range(1, len(items)):
            hist = items[max(0, i - max_his_len):i]
            inp = [t for it in hist for t in item_tokens[it]]
            lab = list(item_tokens[items[i]]) + [eos_token_id]
            if i == len(items) - 1:
                test_x.append(inp)
                test_y.append(lab)
            else:
                train_x.append(inp)
                train_y.append(lab)
    return train_x, train_y, test_x, test_y
