"""Leaderboard submission converters.

A copy of ``vcoder_tpu/eval/converters.py`` for the PyTorch port, which
imports nothing of ``vcoder_tpu``; keep the two in step.

Mirrors the reference scripts (reference: scripts/convert_gqa_for_eval.py,
convert_vizwiz_for_submission.py, convert_vqav2_for_submission.py,
convert_mmbench_for_submission.py) as subcommands of one CLI:

    python -m vcoder_tpu_torch.eval.converters gqa    --src a.jsonl --dst out.json
    python -m vcoder_tpu_torch.eval.converters vizwiz --annotation-file ... \
        --result-file ... --result-upload-file ...
    python -m vcoder_tpu_torch.eval.converters vqav2  --dir ... --ckpt ... --split ...
    python -m vcoder_tpu_torch.eval.converters mmbench --annotation-file ... \
        --result-dir ... --upload-dir ... --experiment ...
"""

from __future__ import annotations

import argparse
import json
import os

from vcoder_tpu_torch.eval.m4c_evaluator import EvalAIAnswerProcessor


def convert_gqa(src: str, dst: str) -> None:
    all_answers = []
    for line in open(src):
        res = json.loads(line)
        all_answers.append(
            {
                "questionId": res["question_id"],
                "prediction": res["text"].rstrip(".").lower(),
            }
        )
    with open(dst, "w") as f:
        json.dump(all_answers, f)


def convert_vizwiz(
    annotation_file: str, result_file: str, result_upload_file: str
) -> None:
    os.makedirs(
        os.path.dirname(result_upload_file) or ".", exist_ok=True
    )
    results = {}
    error_line = 0
    for line in open(result_file):
        try:
            x = json.loads(line)
            results[x["question_id"]] = x["text"]
        except Exception:
            error_line += 1
    test_split = [json.loads(line) for line in open(annotation_file)]
    print(
        f"total results: {len(results)}, total split: {len(test_split)},"
        f" error_line: {error_line}"
    )
    processor = EvalAIAnswerProcessor()
    all_answers = []
    for x in test_split:
        assert x["question_id"] in results
        all_answers.append(
            {
                "image": x["image"],
                "answer": processor(results[x["question_id"]]),
            }
        )
    with open(result_upload_file, "w") as f:
        json.dump(all_answers, f)


def convert_vqav2(dir_: str, ckpt: str, split: str) -> None:
    src = os.path.join(dir_, "answers", split, ckpt, "merge.jsonl")
    test_split_path = os.path.join(
        dir_, "llava_vqav2_mscoco_test2015.jsonl"
    )
    dst = os.path.join(dir_, "answers_upload", split, f"{ckpt}.json")
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)

    results = {}
    error_line = 0
    for line in open(src):
        try:
            x = json.loads(line)
            results[x["question_id"]] = x["text"]
        except Exception:
            error_line += 1
    test_split = [json.loads(line) for line in open(test_split_path)]
    split_ids = set(x["question_id"] for x in test_split)
    print(
        f"total results: {len(results)}, total split: {len(test_split)},"
        f" error_line: {error_line}"
    )
    processor = EvalAIAnswerProcessor()
    all_answers = []
    for x in test_split:
        if x["question_id"] not in results:
            all_answers.append(
                {"question_id": x["question_id"], "answer": ""}
            )
        else:
            all_answers.append(
                {
                    "question_id": x["question_id"],
                    "answer": processor(results[x["question_id"]]),
                }
            )
    with open(dst, "w") as f:
        json.dump(all_answers, f)


def convert_mmbench(
    annotation_file: str, result_dir: str, upload_dir: str, experiment: str
) -> None:
    import pandas as pd

    df = pd.read_table(annotation_file)
    cur_df = df.copy()
    drop = [
        c
        for c in ("hint", "category", "source", "image", "comment",
                  "l2-category")
        if c in cur_df.columns
    ]
    cur_df = cur_df.drop(columns=drop)
    cur_df.insert(min(6, len(cur_df.columns)), "prediction", None)
    for line in open(os.path.join(result_dir, f"{experiment}.jsonl")):
        pred = json.loads(line)
        cur_df.loc[df["index"] == pred["question_id"], "prediction"] = (
            pred["text"]
        )
    os.makedirs(upload_dir, exist_ok=True)
    out = os.path.join(upload_dir, f"{experiment}.xlsx")
    try:
        cur_df.to_excel(out, index=False, engine="openpyxl")
    except ImportError:
        # openpyxl absent: fall back to TSV with the same content. Any
        # OTHER write failure must propagate — the submission server
        # only accepts xlsx, so a silent TSV fallback just defers the
        # error to upload time.
        out = os.path.join(upload_dir, f"{experiment}.tsv")
        cur_df.to_csv(out, sep="\t", index=False)
    print("wrote", out)


def _mme_gt_lookup(benchmark_dir, category, image, question):
    """Ground truth from the official MME release layout: per-image txt
    ('question\\tanswer' lines) under <category>/questions_answers_YN/ or
    beside the images."""
    stem = os.path.splitext(os.path.basename(image))[0]
    for cand in (
        os.path.join(
            benchmark_dir, category, "questions_answers_YN", stem + ".txt"
        ),
        os.path.join(benchmark_dir, category, stem + ".txt"),
    ):
        if os.path.exists(cand):
            for line in open(cand):
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2 and parts[0].strip() == question.strip():
                    return parts[1].strip()
    return None


def convert_mme(
    question_file: str,
    result_file: str,
    output_dir: str,
    benchmark_dir: str | None = None,
) -> None:
    """Answers jsonl -> MME eval_tool per-category txt files
    ('img\\tquestion\\tgt\\tpred' lines). Category comes from the
    question file ('category' field, else the image path's leading
    directory). Ground truth comes from the question file's
    'answer'/'label' field when present, else from the official MME
    release via --benchmark-dir (the stock llava_mme.jsonl carries NO
    answers — writing empty GT would silently zero the benchmark)."""
    questions = {}
    for line in open(question_file):
        q = json.loads(line)
        questions[q["question_id"]] = q
    os.makedirs(output_dir, exist_ok=True)
    files = {}
    try:
        for line in open(result_file):
            a = json.loads(line)
            q = questions.get(a["question_id"], {})
            image = q.get("image", str(a["question_id"]))
            category = q.get("category") or image.split("/")[0]
            pred = a["text"].replace("\n", " ").replace("\t", " ")
            question = q.get("text", a.get("prompt", "")).replace(
                "\n", " "
            ).replace("\t", " ")
            gt = q.get("answer", q.get("label", ""))
            if not gt and benchmark_dir:
                gt = _mme_gt_lookup(
                    benchmark_dir, category, image, question
                ) or ""
            if not gt:
                raise ValueError(
                    f"no ground truth for question {a['question_id']!r}:"
                    " the question file carries no answer field — pass"
                    " --benchmark-dir <MME_Benchmark_release_version>"
                )
            if category not in files:
                files[category] = open(
                    os.path.join(output_dir, f"{category}.txt"), "w"
                )
            files[category].write(
                "\t".join(
                    [os.path.basename(image), question, gt, pred]
                )
                + "\n"
            )
    finally:
        for f in files.values():
            f.close()
    print(f"wrote {len(files)} category files to {output_dir}")


def main():
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("gqa")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p = sub.add_parser("vizwiz")
    p.add_argument("--annotation-file", required=True)
    p.add_argument("--result-file", required=True)
    p.add_argument("--result-upload-file", required=True)
    p = sub.add_parser("vqav2")
    p.add_argument("--dir", required=True)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--split", required=True)
    p = sub.add_parser("mmbench")
    p.add_argument("--annotation-file", required=True)
    p.add_argument("--result-dir", required=True)
    p.add_argument("--upload-dir", required=True)
    p.add_argument("--experiment", required=True)
    p = sub.add_parser("mme")
    p.add_argument("--question-file", required=True)
    p.add_argument("--result-file", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--benchmark-dir", default=None)
    args = parser.parse_args()
    if args.cmd == "gqa":
        convert_gqa(args.src, args.dst)
    elif args.cmd == "vizwiz":
        convert_vizwiz(
            args.annotation_file, args.result_file, args.result_upload_file
        )
    elif args.cmd == "vqav2":
        convert_vqav2(args.dir, args.ckpt, args.split)
    elif args.cmd == "mmbench":
        convert_mmbench(
            args.annotation_file, args.result_dir, args.upload_dir,
            args.experiment,
        )
    elif args.cmd == "mme":
        convert_mme(
            args.question_file, args.result_file, args.output_dir,
            benchmark_dir=args.benchmark_dir,
        )


if __name__ == "__main__":
    main()
