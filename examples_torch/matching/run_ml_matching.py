"""MovieLens-style retrieval examples on the PyTorch port: the full matching model zoo.

Consolidated equivalent of the reference's per-model scripts
(``examples/matching/run_ml_youtube_dnn.py``, ``run_ml_youtube_sbc.py``,
``run_ml_mind.py``, ``run_ml_comirec.py``, ``run_ml_gru4rec.py``,
``run_ml_sine.py``, ``run_ml_facebook_dssm.py``): one CLI, any model,
synthetic MovieLens-shaped interactions through the REAL preprocessing path
(``generate_seq_feature_match`` + ``gen_model_input``), then fit →
``inference_embedding`` → exact top-k retrieval eval.

    python examples_torch/matching/run_ml_matching.py --model_name youtube_dnn
    python examples_torch/matching/run_ml_matching.py --model_name mind --topk 20

The counterpart of ``examples/matching/run_ml_matching.py``; ``--device cpu``
runs it on the CPU.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from examples_torch.datasets import build_ml1m_matching_dataset
from torch_rechub_tpu_torch.basic.features import DenseFeature, SequenceFeature, SparseFeature
from torch_rechub_tpu_torch.models import matching
from torch_rechub_tpu_torch.serving import match_evaluation
from torch_rechub_tpu_torch.trainers import MatchTrainer
from torch_rechub_tpu_torch.trainers.base import resolve_device
from torch_rechub_tpu_torch.utils.data import ArrayLoader

MODELS = ("youtube_dnn", "youtube_sbc", "gru4rec", "mind", "comirec_sa", "comirec_dr", "sine", "facebook_dssm", "dssm_senet")


def build_model(name, n_users, n_items, d, seq_len, generator=None, device=None):
    where = dict(generator=generator, device=device)
    user_id = SparseFeature("user_id", vocab_size=n_users, embed_dim=d)
    hist_mean = SequenceFeature("hist_movie_id", vocab_size=n_items, embed_dim=d, pooling="mean", shared_with="movie_id")
    hist_concat = SequenceFeature("hist_movie_id", vocab_size=n_items, embed_dim=d, pooling="concat", shared_with="movie_id")
    item = (SparseFeature("movie_id", vocab_size=n_items, embed_dim=d),)
    neg = (SequenceFeature("neg_items", vocab_size=n_items, embed_dim=d, pooling="concat", shared_with="movie_id"),)
    if name == "youtube_dnn":
        return matching.YoutubeDNN(user_features=(user_id, hist_mean), item_features=item, neg_item_feature=neg, user_params={"dims": (64, d)}, **where), 2
    if name == "youtube_sbc":
        weight = (DenseFeature("sample_weight"),)
        return matching.YoutubeSBC(user_features=(user_id, hist_mean), item_features=item, sample_weight_feature=weight, user_params={"dims": (64, d)}, item_params={"dims": (64, d)}, batch_size=256, n_neg=3, **where), 2
    if name == "gru4rec":
        return matching.GRU4Rec(user_features=(user_id,), history_features=(hist_concat,), item_features=item, neg_item_feature=neg, user_params={"dims": (64, d), "num_layers": 1}, **where), 2
    if name == "mind":
        return matching.MIND(user_features=(user_id,), history_features=(hist_concat,), item_features=item, neg_item_feature=neg, max_length=seq_len, **where), 2
    if name == "comirec_sa":
        return matching.ComirecSA(user_features=(user_id,), history_features=(hist_concat,), item_features=item, neg_item_feature=neg, **where), 2
    if name == "comirec_dr":
        return matching.ComirecDR(user_features=(user_id,), history_features=(hist_concat,), item_features=item, neg_item_feature=neg, max_length=seq_len, **where), 2
    if name == "sine":
        return matching.SINE(history_features=("hist_movie_id",), item_features=("movie_id",), neg_item_features=("neg_items",), num_items=n_items, embedding_dim=d, hidden_dim=32, num_concept=10, num_intention=4, seq_max_len=seq_len, **where), 2
    if name == "facebook_dssm":
        neg_sparse = (SparseFeature("neg_items", vocab_size=n_items, embed_dim=d, shared_with="movie_id"),)
        return matching.FaceBookDSSM(user_features=(user_id, hist_mean), pos_item_features=item, neg_item_features=neg_sparse, user_params={"dims": (64, d)}, item_params={"dims": (64, d)}, **where), 1
    if name == "dssm_senet":
        return matching.DSSMSENet(user_features=(user_id, hist_mean), item_features=item, user_params={"dims": (64, d)}, item_params={"dims": (64, d)}, **where), 0
    raise ValueError(name)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name", default="youtube_dnn", choices=MODELS)
    parser.add_argument("--epoch", type=int, default=4)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--embed_dim", type=int, default=16)
    parser.add_argument("--seq_max_len", type=int, default=20)
    parser.add_argument("--neg_ratio", type=int, default=3)
    parser.add_argument("--topk", type=int, default=10)
    parser.add_argument("--seed", type=int, default=2022)
    parser.add_argument("--save_dir", default="./saved")
    parser.add_argument("--device", default=None, help="default: the card (raises without one); cpu runs on the CPU")
    args = parser.parse_args()
    device = resolve_device(args.device)

    model, mode = build_model(args.model_name, 200, 300, args.embed_dim, args.seq_max_len, generator=torch.Generator().manual_seed(args.seed), device=device)
    bundle = build_ml1m_matching_dataset(seed=args.seed, embed_dim=args.embed_dim, mode=mode, neg_ratio=args.neg_ratio, seq_max_len=args.seq_max_len)
    x_train, y_train = dict(bundle.x_train), bundle.y_train
    if args.model_name == "youtube_sbc":
        # word2vec sampling-bias weights per item (reference run_ml_youtube_sbc.py:37-38)
        from torch_rechub_tpu_torch.utils.match import get_item_sample_weight

        weight_map = get_item_sample_weight(list(x_train["movie_id"]))
        x_train["sample_weight"] = np.array([weight_map[i] for i in x_train["movie_id"]], dtype=np.float32)

    trainer = MatchTrainer(model, mode=mode, n_epoch=args.epoch, model_path=args.save_dir, device=device)
    trainer.fit(ArrayLoader(x_train, y_train, batch_size=args.batch_size, shuffle=True))

    test_x = {k: v for k, v in bundle.x_test_user.items() if not k.startswith("neg")}
    if args.model_name == "youtube_sbc":
        test_x["sample_weight"] = np.full(len(test_x["user_id"]), min(weight_map.values()), dtype=np.float32)
    user_emb = trainer.inference_embedding(model, "user", ArrayLoader(test_x, batch_size=args.batch_size), args.save_dir)
    item_emb = trainer.inference_embedding(model, "item", ArrayLoader(bundle.x_all_item, batch_size=args.batch_size), args.save_dir)
    match_evaluation(user_emb, item_emb, bundle.test_user, bundle.x_all_item, user_col="user_id", item_col="movie_id", topk=args.topk, device=device)


if __name__ == "__main__":
    main()
