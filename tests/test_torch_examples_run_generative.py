"""Every script of ``examples_torch/generative/`` and ``examples_torch/matching/`` end to end on the CPU
(``--device cpu``), in this process through its argv entry at tiny flags, its printed result line asserted
(``test_torch_examples_run_ranking.py`` holds ``ranking/`` and ``serving/`` and the runner)."""

import math
import re

import pytest
import torch

from test_torch_examples_run_ranking import EXAMPLES, NUMBER, last_match, numbers, run_script

HSTU = ["--epoch", "1", "--d_model", "16", "--n_layers", "1", "--batch_size", "128"]
HLLM = ["--epoch", "1", "--d_model", "16", "--n_users", "100", "--batch_size", "32"]
TIGER = ["--rqvae_epochs", "1", "--tiger_steps", "50"]
MATCH = ["--epoch", "1"]
METRICS = r"^defaultdict\(<class 'list'>, \{'NDCG': \['NDCG@10: " + NUMBER + r"'\].*'Precision': \['Precision@10: " + NUMBER + r"'\]\}\)$"

CASES = {
    "generative/run_hstu.py": (HSTU + ["--vocab", "50", "--seq_len", "8"], r"^hit@10 \(seen filtered\): " + NUMBER + "$"),
    "generative/run_hstu_movielens.py": (HSTU + ["--seq_len", "16"], r"^hit@10 \(seen filtered\): " + NUMBER + "$"),
    "generative/run_hstu_amazon_books.py": (HSTU + ["--seq_len", "16"], r"^hit@10 \(seen filtered\): " + NUMBER + "$"),
    "generative/run_hstu_production_vocab.py": (["--vocab", "300", "--epoch", "1", "--batch_size", "128", "--seq_len", "16", "--num_negatives", "16", "--d_model", "16", "--n_layers", "1", "--steps_per_call", "2"],
                                                r"^test loss " + NUMBER + " top1 acc " + NUMBER + r" \(vocab=300, S=16\)$"),
    "generative/run_hllm.py": (HLLM, r"^test loss: " + NUMBER + "  top-1 hit: " + NUMBER + "$"),
    "generative/run_hllm_movielens.py": (HLLM, r"^test loss: " + NUMBER + "  top-1 hit: " + NUMBER + "$"),
    "generative/run_hllm_amazon_books.py": (HLLM + ["--seq_len", "8"], r"^test loss: " + NUMBER + "  top-1 hit: " + NUMBER + "$"),
    "generative/run_rqvae_tiger.py": (TIGER, r"^recall@5 over semantic ids: " + NUMBER + "$"),
    "generative/run_rqvae_amazon_books.py": (["--rqvae_epochs", "1"], r"^semantic-id vocab: \d+ tokens over 500 items$"),
    "generative/run_tiger_amazon_books.py": (TIGER, r"^recall@5 over semantic ids: " + NUMBER + "$"),
    "generative/run_tiger_movielens.py": (TIGER, r"^recall@5 over semantic ids: " + NUMBER + "$"),
    "matching/run_ml_matching.py": (MATCH + ["--model_name", "dssm_senet"], METRICS),
    "matching/run_ml_youtube_dnn.py": (MATCH, METRICS),
    "matching/run_ml_youtube_sbc.py": (MATCH, METRICS),
    "matching/run_ml_gru4rec.py": (MATCH, METRICS),
    "matching/run_ml_mind.py": (MATCH, METRICS),
    "matching/run_ml_comirec.py": (MATCH, METRICS),
    "matching/run_ml_comirec.py --model_name comirec_dr": (MATCH + ["--model_name", "comirec_dr"], METRICS),
    "matching/run_ml_sine.py": (MATCH, METRICS),
    "matching/run_ml_facebook_dssm.py": (MATCH, METRICS),
    "matching/run_ml_dssm.py": (MATCH + ["--in_batch_neg"], METRICS),
    "matching/run_dssm.py": (MATCH, METRICS),
    "matching/run_sbr.py": (MATCH, r"^test metrics: \{'NDCG@20': " + NUMBER + ".*'Precision@20': " + NUMBER + r"\}$"),
    "matching/run_sbr.py --model_name stamp": (MATCH + ["--model_name", "stamp"], r"^test metrics: \{'NDCG@20': " + NUMBER + ".*'Precision@20': " + NUMBER + r"\}$"),
    "matching/run_sbr.py --model_name sasrec": (MATCH + ["--model_name", "sasrec"], r"^SASRec training done \(synthetic sessions; retrieval eval via run_ml_matching.py\)$"),
    "matching/run_yidian_sbc.py": (MATCH, r"^test metrics: \{'NDCG@10': " + NUMBER + ".*'Precision@10': " + NUMBER + r"\}$"),
}


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("case", sorted(CASES))
def test_generative_and_matching_scripts_run_on_the_cpu(case, tmp_path, monkeypatch, capsys):
    argv, pattern = CASES[case]
    out = run_script(case.split()[0], argv, tmp_path, monkeypatch, capsys)
    line = last_match(pattern, out)
    assert all(math.isfinite(v) for v in numbers(line.split(":", 1)[-1])), line
    if case.startswith("generative/run_hstu"):  # the full-vocab evaluation before it
        assert re.search(r"^test loss:? " + NUMBER + " top1 acc " + NUMBER, out, re.M)


def test_every_generative_and_matching_script_has_a_case():
    scripts = {str(p.relative_to(EXAMPLES)) for d in ("generative", "matching") for p in (EXAMPLES / d).glob("*.py")}
    ran = {case.split()[0] for case in CASES}
    assert scripts - ran == {"matching/movielens_utils.py"}, scripts - ran
    assert ran <= scripts


def test_movielens_utils_re_exports_match_evaluation():
    import runpy

    from torch_rechub_tpu_torch.serving import match_evaluation

    assert runpy.run_path(str(EXAMPLES / "matching" / "movielens_utils.py"))["match_evaluation"] is match_evaluation
