"""The example model builders of the PyTorch port (a copy of ``benchmarks/models.py``'s registry).

``build_ranking_model``, ``build_matching_model`` and ``build_multitask_model``
build the port's models (``torch_rechub_tpu_torch.models``) from a dataset
bundle of ``examples_torch/datasets.py``, with the JAX package's defaults, so
that a name gives the parameters of the JAX builder's model (names and
shapes).  ``generator`` seeds the initial weights; ``device`` places them.
"""

from __future__ import annotations

from torch_rechub_tpu_torch.models import matching, multi_task, ranking

RANKING_MODELS = {"WideDeep", "DeepFM", "DCN", "DCNv2", "AutoInt", "FiBiNet", "EDCN", "AFM"}
MATCHING_MODELS = {"YoutubeDNN", "MIND", "ComirecDR", "ComirecSA", "DSSM"}
MULTITASK_MODELS = {"SharedBottom", "ESMM", "MMOE", "PLE", "AITM"}


def build_ranking_model(name: str, bundle, model_params=None, generator=None, device=None):
    p = dict(model_params or {})
    where = dict(generator=generator, device=device)
    mlp = p.pop("mlp_params", {"dims": (256, 128), "dropout": 0.2, "activation": "relu"})
    sparse = tuple(f for f in bundle.features if hasattr(f, "vocab_size"))
    dense = tuple(f for f in bundle.features if not hasattr(f, "vocab_size"))
    if name == "WideDeep":
        return ranking.WideDeep(wide_features=dense, deep_features=sparse, mlp_params=mlp, **where)
    if name == "DeepFM":
        return ranking.DeepFM(deep_features=dense, fm_features=sparse, mlp_params=mlp, **where)
    if name == "DCN":
        return ranking.DCN(features=bundle.features, n_cross_layers=p.pop("n_cross_layers", 3), mlp_params=mlp, **where)
    if name == "DCNv2":
        return ranking.DCNv2(features=bundle.features, n_cross_layers=p.pop("n_cross_layers", 3), mlp_params=mlp, **p, **where)
    if name == "AutoInt":
        return ranking.AutoInt(sparse_features=sparse, dense_features=dense, mlp_params=mlp, **p, **where)
    if name == "FiBiNet":
        return ranking.FiBiNet(features=sparse, mlp_params=mlp, **p, **where)
    if name == "EDCN":
        return ranking.EDCN(features=sparse, n_cross_layers=p.pop("n_cross_layers", 2), mlp_params=dict(mlp), **p, **where)
    if name == "AFM":
        return ranking.AFM(fm_features=sparse, embed_dim=sparse[0].embed_dim, **p, **where)
    raise KeyError(f"unknown ranking model {name!r} (registry: {sorted(RANKING_MODELS)})")


def build_matching_model(name: str, bundle, model_params=None, generator=None, device=None):
    p = dict(model_params or {})
    where = dict(generator=generator, device=device)
    d = bundle.item_features[0].embed_dim
    user_params = p.pop("user_params", {"dims": (64, d)})
    if name == "DSSM":
        return matching.DSSM(user_features=bundle.user_features, item_features=bundle.item_features, user_params=user_params, item_params=p.pop("item_params", {"dims": (64, d)}), **p, **where)
    common = dict(user_features=(bundle.user_features[0],), item_features=bundle.item_features, neg_item_feature=bundle.neg_item_feature)
    hist_concat = tuple(f.__class__(name=f.name, vocab_size=f.vocab_size, embed_dim=f.embed_dim, pooling="concat", shared_with=f.shared_with) for f in bundle.user_features[1:])
    if name == "YoutubeDNN":
        return matching.YoutubeDNN(user_features=bundle.user_features, item_features=bundle.item_features, neg_item_feature=bundle.neg_item_feature, user_params=user_params, **p, **where)
    if name == "MIND":
        return matching.MIND(**common, history_features=hist_concat, max_length=p.pop("max_length", 20), **p, **where)
    if name == "ComirecDR":
        return matching.ComirecDR(**common, history_features=hist_concat, max_length=p.pop("max_length", 20), **p, **where)
    if name == "ComirecSA":
        return matching.ComirecSA(**common, history_features=hist_concat, **p, **where)
    raise KeyError(f"unknown matching model {name!r} (registry: {sorted(MATCHING_MODELS)})")


def build_multitask_model(name: str, bundle, model_params=None, generator=None, device=None):
    p = dict(model_params or {})
    where = dict(generator=generator, device=device)
    towers = p.pop("tower_params_list", tuple({"dims": (32,)} for _ in bundle.task_types))
    if name == "SharedBottom":
        return multi_task.SharedBottom(features=bundle.features, task_types=bundle.task_types, bottom_params=p.pop("bottom_params", {"dims": (64,)}), tower_params_list=towers, **where)
    if name == "MMOE":
        return multi_task.MMOE(features=bundle.features, task_types=bundle.task_types, n_expert=p.pop("n_expert", 4), expert_params=p.pop("expert_params", {"dims": (64,)}), tower_params_list=towers, **where)
    if name == "PLE":
        return multi_task.PLE(features=bundle.features, task_types=bundle.task_types, n_level=p.pop("n_level", 1), n_expert_specific=p.pop("n_expert_specific", 2), n_expert_shared=p.pop("n_expert_shared", 1), expert_params=p.pop("expert_params", {"dims": (64,)}), tower_params_list=towers, **where)
    if name == "AITM":
        return multi_task.AITM(features=bundle.features, n_task=len(bundle.task_types), bottom_params=p.pop("bottom_params", {"dims": (64,)}), tower_params_list=towers, **where)
    if name == "ESMM":
        half = len(bundle.features) // 2
        return multi_task.ESMM(user_features=bundle.features[:half], item_features=bundle.features[half:], cvr_params=p.pop("cvr_params", {"dims": (32,)}), ctr_params=p.pop("ctr_params", {"dims": (32,)}), **where)
    raise KeyError(f"unknown multitask model {name!r} (registry: {sorted(MULTITASK_MODELS)})")
