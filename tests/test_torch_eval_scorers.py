"""The port's copies of the COST and QA scorers against the JAX package's.

Each test of ``tests/test_eval_scorers.py`` runs here over both packages
(``pkg``), with the same inputs and the same expected values: the NLP core,
extraction, CS/HS/DS math, the GQA and MME scorers, and the quirks the JAX
tests pin (the multi-word number chunk, singularisation over the scoring
vocabulary, the missing-object penalty of DS). Then both packages' command
lines score the same synthetic files and must print the same text
(``seg_accuracy``, ``depth_accuracy``, ``pope``, ``mme_eval``, ``gqa_eval``),
and both packages' converters must write the same files. The port imports
nothing of ``vcoder_tpu``; the scorers are jax-free in both packages.
"""

import importlib
import json
import os
import random
import sys

import numpy as np
import pytest

PKGS = ["vcoder_tpu", "vcoder_tpu_torch"]


def ev(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.eval.{name}")


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


def test_word_to_num(pkg):
    nlp = ev(pkg, "nlp")
    assert nlp.word_to_num("two") == 2
    assert nlp.word_to_num("eighteen") == 18
    assert nlp.word_to_num("twenty five") == 25
    assert nlp.word_to_num("twenty-five") == 25
    assert nlp.word_to_num("7") == 7
    with pytest.raises(ValueError):
        nlp.word_to_num("banana")


def test_num_to_words(pkg):
    nlp = ev(pkg, "nlp")
    assert nlp.num_to_words(1) == "one"
    assert nlp.num_to_words(18) == "eighteen"
    assert nlp.num_to_words(25) == "twenty-five"
    assert nlp.num_to_words(40) == "forty"


def test_plural_singular(pkg):
    nlp = ev(pkg, "nlp")
    assert nlp.plural("person") == "people"
    assert nlp.plural("car") == "cars"
    assert nlp.plural("bench") == "benches"
    assert nlp.plural("knife") == "knives"
    assert nlp.plural("wine glass") == "wine glasses"
    assert nlp.singular_noun("people") == "person"
    assert nlp.singular_noun("cars") == "car"
    assert nlp.singular_noun("benches") == "bench"
    assert nlp.singular_noun("car") is False
    assert nlp.singular_noun("grass") is False
    assert nlp.singular_noun("bus") is False


def test_remove_specific_word_dedup(pkg):
    ex = ev(pkg, "extraction")
    out = ex.remove_specific_word("wall, person, wall, window, car, window", "wall")
    out = ex.remove_specific_word(out, "window")
    assert out.count("wall") == 1
    assert out.count("window") == 1
    assert "person" in out and "car" in out


def test_get_num_nouns(pkg):
    text = ("The objects present in the image are: two people, a car, "
            "three buses, eighteen bottles.")
    assert ev(pkg, "extraction").get_num_nouns(text) == {"people": 2, "buses": 3, "bottles": 18}


def test_obtain_nouns_counts_and_merge(pkg):
    out = ev(pkg, "extraction").obtain_nouns(
        "The objects present in the image are: wall, dining table, two people, car")
    assert out["people"] == 2
    assert out["wall"] == 1
    assert out["dining table"] == 1
    assert out["car"] == 1
    assert "image" not in out and "objects" not in out


def test_word_to_com_canonicalization(pkg):
    ex = ev(pkg, "extraction")
    w2c = ex.build_word_to_com(include_plurals=True)
    assert w2c["man"] == "person"
    assert w2c["men"] == "people"
    assert w2c["automobile"] == "car"
    assert ex.obtain_nouns("a man and a kid near an automobile", w2c) == {"people": 2, "car": 1}


def _write_cost_files(tmp_path):
    gt_dir = tmp_path / "gt"
    pred_dir = tmp_path / "pred"
    gt_dir.mkdir()
    pred_dir.mkdir()
    for task in ("semantic", "instance", "panoptic"):
        (gt_dir / f"{task}.txt").write_text(
            "<IMG>img1.jpg<IMG>The objects present in the image are: two people, a car, wall\n"
            "<IMG>img2.jpg<IMG>The objects present in the image are: three dogs\n")
        (pred_dir / f"output_{task}.txt").write_text(
            "Image: img1.jpg\n<<QUESTION>>: What objects can be seen in the image?\n"
            "<<ANSWER>>: The objects present in the image are: two people, a car, wall</s>\n"
            "--------\n"
            "Image: img2.jpg\n<<QUESTION>>: What objects can be seen in the image?\n"
            "<<ANSWER>>: The objects present in the image are: two dogs, a cat</s>\n"
            "--------\n")
    return gt_dir, pred_dir


def test_cs_hs_scoring_end_to_end(pkg, tmp_path):
    gt_dir, pred_dir = _write_cost_files(tmp_path)
    acc, hall = ev(pkg, "seg_accuracy").calculate_accuracy_hallucination(
        str(gt_dir), str(pred_dir), write_json=False)
    for task in ("semantic", "instance", "panoptic"):
        np.testing.assert_allclose(acc[task][0], 1.0)
        np.testing.assert_allclose(hall[task][0], 0.0)
        np.testing.assert_allclose(acc[task][1], 2 / 3, atol=1e-6)
        np.testing.assert_allclose(hall[task][1], 2 / 3, atol=1e-6)


def test_ds_scoring(pkg, tmp_path):
    gt = tmp_path / "gt.txt"
    pred = tmp_path / "pred.txt"
    gt.write_text("<IMG>img1.jpg<IMG>The depth order for the objects present in the "
                  "image is: person, car, tree\n")
    pred.write_text("Image: img1.jpg\n<<QUESTION>>: q\n<<ANSWER>>: The depth order for the "
                    "objects present in the image is: car, person, tree</s>\n")
    scores = ev(pkg, "depth_accuracy").calculate_depth_score(str(gt), str(pred))
    np.testing.assert_allclose(scores[0], 2 / 3, atol=1e-6)


def test_ds_missing_object_penalty(pkg):
    np.testing.assert_allclose(
        ev(pkg, "depth_accuracy").score_pair("order: person, car", "order: person"), 50.0)


def test_questions_match_jax():
    """The port's copy of the question banks and paragraph suffixes. (The
    JAX file's test of ``data_utils``'s QA synthesis has its counterpart in
    tests/test_torch_train_datasets.py.)"""
    import vcoder_tpu.questions as jq
    import vcoder_tpu_torch.questions as tq

    assert tq.QUESTIONS == jq.QUESTIONS
    assert tq.SEG_PARAGRAPH_SUFFIX == jq.SEG_PARAGRAPH_SUFFIX
    assert tq.DEPTH_PARAGRAPH_SUFFIX == jq.DEPTH_PARAGRAPH_SUFFIX
    for name in ("SEMANTIC", "INSTANCE", "PANOPTIC", "DEPTH"):
        assert getattr(tq, f"{name}_QUESTIONS") == getattr(jq, f"{name}_QUESTIONS")


def _gqa_q(answer, structural="query", semantic="attr", detailed="x",
           question="what color is the car ?", steps=None, entailed=(), balanced=True,
           group=None):
    return {
        "answer": answer, "isBalanced": balanced, "question": question,
        "types": {"structural": structural, "semantic": semantic, "detailed": detailed},
        "semantic": steps if steps is not None else [
            {"operation": "select", "argument": "car"},
            {"operation": "query: name", "argument": ""}],
        "entailed": list(entailed), "groups": {"global": group},
    }


def test_gqa_official_accuracy_binary_open_and_balanced_filter(pkg):
    questions = {"q1": _gqa_q("red", structural="query"),
                 "q2": _gqa_q("yes", structural="verify"),
                 "q3": _gqa_q("no", structural="logical"),
                 "q4": _gqa_q("blue", balanced=False)}
    out = ev(pkg, "gqa_eval").evaluate(questions, {"q1": "red", "q2": "no", "q3": "no"})
    assert out["n"] == 3
    assert out["accuracy"] == round(2 / 3 * 100, 2)
    assert out["open"] == 100.0
    assert out["binary"] == 50.0
    assert out["accuracyPerStructuralType"]["verify"] == (0.0, 1)


def test_gqa_official_validity_common_normalization(pkg):
    questions = {"q1": _gqa_q("red", detailed="typeVerifyC"),
                 "q2": _gqa_q("red", detailed="chooseCommon")}
    choices = {"q1": {"valid": ["red", "blue"], "plausible": ["red"]},
               "q2": {"valid": ["red"], "plausible": ["red"]}}
    out = ev(pkg, "gqa_eval").evaluate(questions, {"q1": "green", "q2": "material"},
                                       choices=choices)
    assert out["validity"] == 50.0
    assert out["plausibility"] == 50.0


def test_gqa_official_consistency_and_missing_prediction(pkg):
    evaluate = ev(pkg, "gqa_eval").evaluate
    questions = {"q1": _gqa_q("red", entailed=["e1", "e2"]),
                 "e1": _gqa_q("yes", structural="verify", balanced=False),
                 "e2": _gqa_q("no", structural="verify", balanced=False)}
    preds = {"q1": "red", "e1": "yes", "e2": "yes"}
    assert evaluate(questions, preds, consistency=True)["consistency"] == 50.0
    assert evaluate(questions, {**preds, "q1": "blue"}, consistency=True)["consistency"] == 0.0
    with pytest.raises(ValueError, match="no prediction"):
        evaluate(questions, {"q1": "red"}, consistency=True)


def test_gqa_official_distribution_and_steps(pkg):
    steps = [{"operation": "select", "argument": "car"},
             {"operation": "filter color", "argument": "red"},
             {"operation": "exist", "argument": "?"}]
    questions = {"q1": _gqa_q("red", group="color", steps=steps),
                 "q2": _gqa_q("blue", group="color")}
    out = ev(pkg, "gqa_eval").evaluate(questions, {"q1": "red", "q2": "red"})
    assert out["distribution"] == round(2.0 / 100.0, 2)
    assert out["accuracyPerSteps"][2] == (100.0, 1)
    assert out["accuracyPerSteps"][1] == (0.0, 1)


def test_mme_converter_scorer_roundtrip(pkg, tmp_path):
    qf = tmp_path / "llava_mme.jsonl"
    rf = tmp_path / "answers.jsonl"
    qs = [
        {"question_id": 1, "image": "existence/A.jpg", "text": "Is there a dog?", "answer": "yes", "category": "existence"},
        {"question_id": 2, "image": "existence/A.jpg", "text": "Is there a cat?", "answer": "no", "category": "existence"},
        {"question_id": 3, "image": "existence/B.jpg", "text": "Is there a car?", "answer": "yes", "category": "existence"},
        {"question_id": 4, "image": "existence/B.jpg", "text": "Is there a bus?", "answer": "no", "category": "existence"},
        {"question_id": 5, "image": "code_reasoning/C.jpg", "text": "Will it print 3?", "answer": "yes", "category": "code_reasoning"},
        {"question_id": 6, "image": "code_reasoning/C.jpg", "text": "Will it crash?", "answer": "no", "category": "code_reasoning"},
    ]
    answers = {1: "Yes, there is.", 2: "No", 3: "yes", 4: "Yes it is", 5: "yes", 6: "no."}
    qf.write_text("".join(json.dumps(q) + "\n" for q in qs))
    rf.write_text("".join(json.dumps({"question_id": k, "text": v}) + "\n"
                          for k, v in answers.items()))
    out_dir = tmp_path / "converted"
    ev(pkg, "converters").convert_mme(str(qf), str(rf), str(out_dir))
    assert sorted(p.name for p in out_dir.glob("*.txt")) == ["code_reasoning.txt", "existence.txt"]
    line = open(out_dir / "existence.txt").readline().rstrip("\n").split("\t")
    assert line[0] == "A.jpg" and line[2] == "yes"
    mme = ev(pkg, "mme_eval")
    res = mme.evaluate_dir(str(out_dir))
    ex = res["categories"]["existence"]
    assert ex["acc"] == 0.75
    assert ex["acc_plus"] == 0.5
    assert abs(ex["score"] - 125.0) < 1e-9
    assert res["categories"]["code_reasoning"]["score"] == 200.0
    assert abs(res["perception"] - 125.0) < 1e-9
    assert res["cognition"] == 200.0
    assert mme.parse_pred("Yes, there is") == "yes"
    assert mme.parse_pred("Nothing") == "no"
    assert mme.parse_pred(" NO.") == "no"
    assert mme.parse_pred("maybe") == "other"
    assert mme.parse_pred("unclear") == "other"


def test_singularization_roundtrip_over_scoring_vocab(pkg):
    nlp = ev(pkg, "nlp")
    words = set()
    for line in open(os.path.join(os.path.dirname(nlp.__file__), "synonyms.txt")):
        for w in line.split(","):
            w = w.strip().lower()
            if w and " " not in w:
                words.add(w)
    failures = []
    for w in sorted(words):
        if nlp.singular_noun(w):
            continue
        p = nlp.plural(w)
        back = nlp.singular_noun(p)
        if back != w and (not back or nlp.plural(back) != p):
            failures.append((w, p, back))
    assert not failures, failures


def test_singularization_known_cases(pkg):
    singular_noun = ev(pkg, "nlp").singular_noun
    cases = {"ties": "tie", "houses": "house", "horses": "horse", "vases": "vase",
             "gloves": "glove", "shoes": "shoe", "toes": "toe", "buses": "bus", "boxes": "box",
             "benches": "bench", "glasses": "glass", "potatoes": "potato", "knives": "knife",
             "wolves": "wolf", "cities": "city", "purses": "purse", "waves": "wave"}
    assert {k: singular_noun(k) for k in cases} == cases


def test_multiword_number_chunks_match_reference_quirk(pkg):
    get_num_nouns = ev(pkg, "extraction").get_num_nouns
    assert ev(pkg, "nlp").extract_num_noun_chunks("twenty three bottles") == [
        "twenty three bottles"]
    assert get_num_nouns("twenty three bottles") == {"three bottles": 20}
    assert get_num_nouns("two people and three buses") == {"people": 2, "buses": 3}


def test_obtain_seg_texts_tolerates_blank_lines(pkg, tmp_path):
    f = tmp_path / "gt.txt"
    f.write_text("<IMG>a.jpg<IMG>two people, a car\n\n\n")
    assert ev(pkg, "extraction").obtain_seg_texts(str(f)) == {"a.jpg": "two people, a car"}


def test_convert_mme_reads_benchmark_gt(pkg, tmp_path):
    convert_mme = ev(pkg, "converters").convert_mme
    q = tmp_path / "q.jsonl"
    q.write_text(json.dumps({"question_id": 1, "image": "color/0001.jpg",
                             "text": "Is the sky blue? Please answer yes or no.",
                             "category": "color"}) + "\n")
    r = tmp_path / "r.jsonl"
    r.write_text(json.dumps({"question_id": 1, "text": "Yes"}) + "\n")
    bench = tmp_path / "bench" / "color" / "questions_answers_YN"
    bench.mkdir(parents=True)
    (bench / "0001.txt").write_text("Is the sky blue? Please answer yes or no.\tYes\n")
    out = tmp_path / "out"
    convert_mme(str(q), str(r), str(out), benchmark_dir=str(tmp_path / "bench"))
    img, question, gt, pred = (out / "color.txt").read_text().strip().split("\t")
    assert gt == "Yes" and pred == "Yes"
    with pytest.raises(ValueError, match="no ground truth"):
        convert_mme(str(q), str(r), str(tmp_path / "out2"))


# ---- both packages' command lines on the same files ------------------------

OBJECTS = ["person", "car", "wall", "tree", "sky", "road", "dog", "bench", "window", "grass",
           "man", "kid", "automobile", "bus", "knife", "tie", "wine glass", "dining table"]
WORDS = ["two", "three", "a", "eighteen", "twenty three", "five"]


def _random_list(rng, n):
    out = []
    for _ in range(n):
        obj = rng.choice(OBJECTS)
        out.append(obj if rng.random() < 0.5 else f"{rng.choice(WORDS)} {obj}s")
    return ", ".join(out)


def _cost_tree(root, seed=0, n=12):
    rng = random.Random(seed)
    gt, pred = root / "gt", root / "pred"
    gt.mkdir()
    pred.mkdir()
    for task in ("semantic", "instance", "panoptic"):
        g, p = [], []
        for i in range(n):
            g.append(f"<IMG>k{i}.jpg<IMG>The objects present in the image are: "
                     f"{_random_list(rng, rng.randint(1, 6))}\n")
            p.append(f"Image: k{i}.jpg\n<<QUESTION>>: q\n<<ANSWER>>: The objects present in "
                     f"the image are: {_random_list(rng, rng.randint(0, 6))}</s>\n" + "-" * 55
                     + "\n")
        (gt / f"{task}.txt").write_text("".join(g))
        (pred / f"output_{task}.txt").write_text("".join(p))
    orders, answers = [], []
    for i in range(n):
        objs = [rng.choice(OBJECTS) + (f"-{rng.randint(2, 3)}" if rng.random() < 0.3 else "")
                for _ in range(rng.randint(1, 7))]
        orders.append(f"<IMG>k{i}.jpg<IMG>The depth order for the objects present in the image "
                      f"is: {', '.join(objs)}\n")
        rng.shuffle(objs)
        said = objs[: rng.randint(0, len(objs))] + [rng.choice(OBJECTS)]
        answers.append(f"Image: k{i}.jpg\n<<QUESTION>>: q\n<<ANSWER>>: The depth order for the "
                       f"objects present in the image is: {', '.join(said)}</s>\n" + "-" * 55
                       + "\n")
    (root / "order.txt").write_text("".join(orders))
    (root / "depth_answers.txt").write_text("".join(answers))
    return gt, pred


def _printed(capsys, monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module] + argv)
    importlib.import_module(module).main()
    return capsys.readouterr().out


def _both(capsys, monkeypatch, name, argv):
    return [_printed(capsys, monkeypatch, f"{p}.eval.{name}", argv) for p in PKGS]


@pytest.mark.parametrize("seed", [0, 1])
def test_cs_hs_and_ds_print_the_same_numbers(seed, tmp_path, capsys, monkeypatch):
    gt, pred = _cost_tree(tmp_path, seed)
    j, t = _both(capsys, monkeypatch, "seg_accuracy", ["--gt_path", str(gt), "--pred_path",
                                                       str(pred)])
    assert j == t and "Average accuracy for panoptic segmentation is:" in t
    j, t = _both(capsys, monkeypatch, "depth_accuracy",
                 ["--gt_path", str(tmp_path / "order.txt"),
                  "--pred_path", str(tmp_path / "depth_answers.txt")])
    assert j == t and "Average depth score is:" in t
    j, t = _both(capsys, monkeypatch, "seg_accuracy_gpt4",
                 ["--gt_path", str(gt), "--pred_path", str(pred)])
    assert j == t


def test_pope_prints_the_same_numbers(tmp_path, capsys, monkeypatch):
    rng = random.Random(3)
    ann = tmp_path / "coco"
    ann.mkdir()
    qs, ans = [], []
    for cat in ("random", "popular", "adversarial"):
        labels = []
        for _ in range(9):
            qid = len(qs)
            qs.append({"question_id": qid, "image": f"{qid}.jpg", "text": "Is there a car?",
                       "category": cat})
            ans.append({"question_id": qid, "text": rng.choice(
                ["Yes, there is.", "No.", "There is not a car.", "yes", "No, it is a bus. Yes"])})
            labels.append({"question_id": qid, "label": rng.choice(["yes", "no"])})
        (ann / f"coco_pope_{cat}.json").write_text("".join(json.dumps(x) + "\n" for x in labels))
    (tmp_path / "q.jsonl").write_text("".join(json.dumps(x) + "\n" for x in qs))
    (tmp_path / "a.jsonl").write_text("".join(json.dumps(x) + "\n" for x in ans))
    j, t = _both(capsys, monkeypatch, "pope", [
        "--annotation-dir", str(ann), "--question-file", str(tmp_path / "q.jsonl"),
        "--result-file", str(tmp_path / "a.jsonl")])
    assert j == t and t.count("F1 score:") == 3


def test_mme_and_gqa_print_the_same_numbers(tmp_path, capsys, monkeypatch):
    rng = random.Random(4)
    res = tmp_path / "mme"
    res.mkdir()
    for cat in ("existence", "count", "code_reasoning", "OCR"):
        lines = []
        for i in range(6):
            for q in range(2):
                lines.append(f"{i}.jpg\tq{q}?\t{rng.choice(['Yes', 'No'])}\t"
                             f"{rng.choice(['Yes.', 'no', 'Nothing', 'maybe', 'NO'])}\n")
        (res / f"{cat}.txt").write_text("".join(lines))
    j, t = _both(capsys, monkeypatch, "mme_eval", ["--results_dir", str(res)])
    assert j == t and "perception total:" in t

    questions, preds = {}, []
    for i in range(20):
        questions[str(i)] = _gqa_q(rng.choice(["red", "blue", "yes", "no"]),
                                   structural=rng.choice(["query", "verify", "logical"]),
                                   group=rng.choice(["color", None]),
                                   entailed=[str((i + 1) % 20)])
        preds.append({"questionId": str(i), "prediction": rng.choice(["red", "blue", "yes"])})
    (tmp_path / "gq.json").write_text(json.dumps(questions))
    (tmp_path / "gp.json").write_text(json.dumps(preds))
    choices = {k: {"valid": ["red", "yes"], "plausible": ["red"]} for k in questions}
    (tmp_path / "gc.json").write_text(json.dumps(choices))
    j, t = _both(capsys, monkeypatch, "gqa_eval", [
        "--questions", str(tmp_path / "gq.json"), "--predictions", str(tmp_path / "gp.json"),
        "--choices", str(tmp_path / "gc.json"), "--consistency"])
    assert j == t and "Accuracy:" in t


def _answers(path, n, texts):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(json.dumps({"question_id": i, "text": texts[i % len(texts)]}) + "\n"
                            for i in range(n)))


TEXTS = ["Yes.", "Two dogs, running!", "it's a CAT", "no", "The answer is 3.", "ten"]


def test_converters_write_the_same_files(tmp_path, monkeypatch, capsys):
    out = {}
    for p in PKGS:
        root = tmp_path / p
        _answers(root / "gqa.jsonl", 8, TEXTS)
        _answers(root / "vizwiz.jsonl", 8, TEXTS)
        (root / "vizwiz_test.jsonl").write_text("".join(
            json.dumps({"question_id": i, "image": f"v{i}.jpg"}) + "\n" for i in range(8)))
        split = "llava_vqav2_mscoco_test-dev2015"
        _answers(root / "answers" / split / "m" / "merge.jsonl", 6, TEXTS)
        (root / "llava_vqav2_mscoco_test2015.jsonl").write_text("".join(
            json.dumps({"question_id": i}) + "\n" for i in range(8)))
        conv = ev(p, "converters")
        for argv in (["gqa", "--src", str(root / "gqa.jsonl"), "--dst", str(root / "g.json")],
                     ["vizwiz", "--annotation-file", str(root / "vizwiz_test.jsonl"),
                      "--result-file", str(root / "vizwiz.jsonl"),
                      "--result-upload-file", str(root / "up" / "v.json")],
                     ["vqav2", "--dir", str(root), "--ckpt", "m", "--split", split]):
            monkeypatch.setattr(sys, "argv", ["converters"] + argv)
            conv.main()
        out[p] = [(root / "g.json").read_bytes(), (root / "up" / "v.json").read_bytes(),
                  (root / "answers_upload" / split / "m.json").read_bytes()]
    capsys.readouterr()
    assert out["vcoder_tpu"] == out["vcoder_tpu_torch"]
    assert json.loads(out["vcoder_tpu_torch"][1])[1]["answer"] == "2 dogs running"


def test_mmbench_converter_writes_the_same_table(tmp_path, capsys):
    pd = pytest.importorskip("pandas")
    rows = [{"index": i, "question": f"q{i}", "hint": "h", "A": "a", "B": "b", "C": "c",
             "D": "d", "answer": "A", "category": "x", "image": "img"} for i in range(4)]
    tables = {}
    for p in PKGS:
        root = tmp_path / p
        (root / "res").mkdir(parents=True)
        pd.DataFrame(rows).to_csv(root / "mmb.tsv", sep="\t", index=False)
        _answers(root / "res" / "exp.jsonl", 4, ["A", "B", "The answer is C", "D."])
        ev(p, "converters").convert_mmbench(str(root / "mmb.tsv"), str(root / "res"),
                                            str(root / "up"), "exp")
        (written,) = os.listdir(root / "up")
        tables[p] = (written, (root / "up" / written).read_bytes())
    capsys.readouterr()
    if tables["vcoder_tpu"][0].endswith(".xlsx"):  # a zip with timestamps: compare the cells
        frames = [pd.read_excel(tmp_path / p / "up" / tables[p][0]) for p in PKGS]
        assert frames[0].equals(frames[1])
    else:
        assert tables["vcoder_tpu"] == tables["vcoder_tpu_torch"]
