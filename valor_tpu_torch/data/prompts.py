"""Task prompts (counterpart of ``valor_tpu/data/prompts.py``).

With ``use_task_prompt`` on, the reference feeds a fixed sentence into every
objective (model/modeling.py:355-369 ``get_task_prompt``; call sites
model/pretrain.py:255-256 contra, :438/:451/:463 caption, :492/:505/:516 per
group MLM, :834-859 finetune caption, :949-977 generation, :1270-1321 the QA
splice); the VALOR-large pretraining config sets it.

Each sentence is tokenized once here, on the host, and added to the batches as
``prompt_tokens_*`` arrays ([1, P], broadcast over the batch by the model);
the QA prompt's body goes into the question tokens as the reference puts it:
``[CLS] + body + question[1:]``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from valor_tpu_torch.core.tasks import TaskSpec

# the reference's sentences (model/pretrain.py, see the module docstring)
CONTRA_PROMPT = "project language in common space"
CAPTION_PROMPT = "describe the video with natural language"
MLM_PROMPTS = {
    "tva": "predict masked tokens with visual and audio cues",
    "tv": "predict masked tokens with visual cues",
    "ta": "predict masked tokens with audio cues",
}
QA_PROMPT = "answer the question"


class PromptTable:
    """The prompts' token arrays, tokenized once.

    A sentence is wrapped in its tokenizer's begin and end ids
    (modeling.py:355-369): BERT ``[CLS] ids [SEP]``, CLIP ``sot ids eot``.  The
    contrastive prompt follows the *text* encoder's tokenizer; the caption, MLM
    and QA prompts follow the fusion encoder's."""

    def __init__(self, bert_tokenizer=None, clip_tokenizer=None,
                 txt_encoder_type: str = "bert_base_uncased",
                 multimodal_encoder_type: str = "bert_base_uncased"):
        self._bert = bert_tokenizer
        self._clip = clip_tokenizer
        self._txt_type = txt_encoder_type
        self._mm_type = multimodal_encoder_type
        self._cache: Dict[Any, np.ndarray] = {}

    def _encode(self, sentence: str, encoder_type: str, wrap: bool = True) -> np.ndarray:
        key = (sentence, encoder_type, wrap)
        if key not in self._cache:
            if encoder_type.startswith("clip"):
                if self._clip is None:
                    raise ValueError("a CLIP tokenizer is needed for the prompts")
                ids = self._clip.encode(sentence)
                full = [self._clip.sot_token] + ids + [self._clip.eot_token]
            else:
                if self._bert is None:
                    raise ValueError("a BERT tokenizer is needed for the prompts")
                ids = self._bert.convert_tokens_to_ids(self._bert.tokenize(sentence))
                full = [self._bert.cls_token_id] + ids + [self._bert.sep_token_id]
            self._cache[key] = np.asarray(full if wrap else full[1:-1], np.int32)[None]
        return self._cache[key]

    def contra(self) -> np.ndarray:
        return self._encode(CONTRA_PROMPT, self._txt_type)

    def caption(self) -> np.ndarray:
        return self._encode(CAPTION_PROMPT, self._mm_type)

    def mlm(self, group: str) -> np.ndarray:
        return self._encode(MLM_PROMPTS.get(group, MLM_PROMPTS["tva"]), self._mm_type)

    def qa_body(self) -> np.ndarray:
        """The QA sentence without its begin and end ids (the reference strips
        them before the splice, pretrain.py:1272 ``task_prompt[:,1:-1]``)."""
        return self._encode(QA_PROMPT, self._mm_type, wrap=False)

    def inject(self, batch: Dict[str, Any], spec: TaskSpec) -> Dict[str, Any]:
        """``batch`` with the prompt arrays of every objective ``spec`` runs."""
        out = dict(batch)
        if spec.family == "qa":
            q = np.asarray(out["question_prompt"])
            body = np.broadcast_to(self.qa_body(), (q.shape[0], self.qa_body().shape[1]))
            out["question_prompt"] = np.concatenate([q[:, :1], body, q[:, 1:]], axis=1)
            return out
        if spec.contra_groups or spec.family == "ret":
            out["prompt_tokens_contra"] = self.contra()
        if spec.caption_groups or spec.family == "cap":
            out["prompt_tokens_caption"] = self.caption()
        for g in spec.mlm_groups:
            out[f"prompt_tokens_mlm_{g}"] = self.mlm(g)
        return out


def maybe_prompt_table(model_cfg, tokenizers) -> Optional[PromptTable]:
    """A ``PromptTable`` when ``use_task_prompt`` is on (reference:
    pretrain.py:82), else None."""
    if not model_cfg.use_task_prompt:
        return None
    bert_tok, clip_tok = tokenizers
    return PromptTable(bert_tokenizer=bert_tok, clip_tokenizer=clip_tok,
                       txt_encoder_type=model_cfg.txt_encoder_type,
                       multimodal_encoder_type=model_cfg.multimodal_encoder_type)


def prompted_collate(collate_fn, prompts: Optional[PromptTable], spec: TaskSpec):
    """``collate_fn`` followed by ``prompts.inject`` (``collate_fn`` itself
    without a table)."""
    if prompts is None:
        return collate_fn

    def fn(items):
        return prompts.inject(collate_fn(items), spec)

    return fn
