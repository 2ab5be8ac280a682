"""Submission-level evaluation dispatch (MR + HL), reference-compatible.

Produces the same nested metric dict and "brief" key names as
eval/eval.py:292-374, so downstream model selection (--main_metric lookups
like "MR-full-mAP") works unchanged.
"""
from __future__ import annotations

from collections import OrderedDict

from univtg_tpu_torch.evals.mr_metrics import eval_moment_retrieval
from univtg_tpu_torch.evals.hl_metrics import eval_highlight


def eval_submission(
    submission, ground_truth, verbose=False, match_number=True, num_workers=8
):
    pred_qids = {e["qid"] for e in submission}
    gt_qids = {e["qid"] for e in ground_truth}
    if match_number:
        assert pred_qids == gt_qids, "qids in ground_truth and submission must match"
    else:
        shared = pred_qids & gt_qids
        submission = [e for e in submission if e["qid"] in shared]
        ground_truth = [e for e in ground_truth if e["qid"] in shared]

    metrics = {}
    brief = OrderedDict()
    if "pred_relevant_windows" in submission[0]:
        mr = eval_moment_retrieval(
            submission, ground_truth, verbose=verbose, num_workers=num_workers
        )
        metrics.update(mr)
        mr_brief = {
            "MR-full-mAP-key": mr["full"]["MR-mAP"]["average"],
            "MR-full-mAP@0.5-key": mr["full"]["MR-mAP"]["0.5"],
            "MR-full-mAP@0.75-key": mr["full"]["MR-mAP"]["0.75"],
            "MR-short-mAP": mr["short"]["MR-mAP"]["average"],
            "MR-middle-mAP": mr["middle"]["MR-mAP"]["average"],
            "MR-long-mAP": mr["long"]["MR-mAP"]["average"],
            "MR-short-mIoU": mr["short"]["MR-mIoU"],
            "MR-middle-mIoU": mr["middle"]["MR-mIoU"],
            "MR-long-mIoU": mr["long"]["MR-mIoU"],
            "MR-full-mIoU-key": mr["full"]["MR-mIoU"],
            "MR-full-R1@0.3-key": mr["full"]["MR-R1"]["0.3"],
            "MR-full-R1@0.5-key": mr["full"]["MR-R1"]["0.5"],
            "MR-full-R1@0.7-key": mr["full"]["MR-R1"]["0.7"],
            "MR-full-R5@0.3-key": mr["full"]["MR-R5"]["0.3"],
            "MR-full-R5@0.5-key": mr["full"]["MR-R5"]["0.5"],
            "MR-full-R5@0.7-key": mr["full"]["MR-R5"]["0.7"],
        }
        brief.update(sorted(mr_brief.items(), key=lambda x: x[0]))

    if "pred_saliency_scores" in submission[0] and "saliency_scores" in ground_truth[0]:
        if isinstance(ground_truth[0]["saliency_scores"], list):
            hl = eval_highlight(
                submission, ground_truth, verbose=verbose, num_workers=num_workers
            )
            metrics.update(hl)
            hl_brief = dict(
                (f"{k}-{sub_k.split('-')[1]}", v[sub_k])
                for k, v in hl.items()
                for sub_k in v
            )
            brief.update(hl_brief)
            brief["HL-min-VeryGood-mAP-key"] = brief.pop("HL-min-VeryGood-mAP")
            brief["HL-min-VeryGood-Hit1-key"] = brief.pop("HL-min-VeryGood-Hit1")

    final = OrderedDict()
    final["brief"] = brief
    final.update(sorted(metrics.items(), key=lambda x: x[0]))
    return final
