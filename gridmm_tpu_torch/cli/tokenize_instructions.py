"""Offline instruction tokenization, BERT / XLM-R ids (twin of
gridmm_tpu/cli/tokenize_instructions.py).

Equivalent of the reference's BERTidx preprocessing
(VLN_CE/data/.../process_instrs_to_bert_idx.py:18-40) and the `_enc.json`
generation convention: read annotation JSON with raw `instructions`, write the
same items with `instr_encodings` added.

  python -m gridmm_tpu_torch.cli.tokenize_instructions \
      --input R2R_train.json --output R2R_train_enc.json --tokenizer bert
"""

from __future__ import annotations

import argparse
import gzip
import json


def get_tokenizer(name: str):
    """The Hugging Face tokenizer of `name` ("bert" or "xlm"); transformers
    is imported here, when the CLI runs, and needs the tokenizer's files."""
    from transformers import AutoTokenizer

    model = {"bert": "bert-base-uncased", "xlm": "xlm-roberta-base"}[name]
    return AutoTokenizer.from_pretrained(model)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--tokenizer", choices=["bert", "xlm"], default="bert")
    p.add_argument("--max_len", type=int, default=512)
    args = p.parse_args(argv)

    opener = gzip.open if args.input.endswith(".gz") else open
    with opener(args.input, "rt") as f:
        data = json.load(f)
    items = data["episodes"] if isinstance(data, dict) else data

    tok = get_tokenizer(args.tokenizer)
    for item in items:
        if "instructions" in item:
            item["instr_encodings"] = [
                tok.encode(instr, truncation=True, max_length=args.max_len)
                for instr in item["instructions"]]
        elif "instruction" in item:
            text = item["instruction"]
            if isinstance(text, dict):  # VLN-CE episode format
                text = text["instruction_text"]
            item.setdefault("instruction", {})
            enc = tok.encode(text, truncation=True, max_length=args.max_len)
            if isinstance(item["instruction"], dict):
                item["instruction"]["instruction_tokens"] = enc
            else:
                item["instr_encoding"] = enc

    opener2 = gzip.open if args.output.endswith(".gz") else open
    with opener2(args.output, "wt") as f:
        json.dump(data, f)
    print(f"tokenized {len(items)} items -> {args.output}")


if __name__ == "__main__":
    main()
