"""Offline VLM captioning: captions and pooled hidden-state embeddings per
image with Qwen2-VL. Counterpart of reed_tpu/data/captioning.py (reference:
image/vlm_captioning/{captioning.py, captioning_embedding.py}).

Stage 1 captions each image with Qwen2-VL-2B and saves a `.txt` and the
mean-pooled last hidden state `.npy`; stage 2 embeds (image, caption)
pairs with Qwen2-VL-7B and saves the selected hidden layers (0 / 1 / 15 /
last), mean-pooled, under `text_embeds_qwen7b_l{k}/`. The training path
only reads these `.npy` files (data/image.CachedLatentDataset's
`text_embeds_subdir`). The transformers calls live in `QwenBackend`, which
imports transformers when it is built and runs on an explicit device; the
stage functions own the prompt and the file layout and take any backend
(`StubBackend` writes deterministic vectors without weights).

  python -m reed_tpu_torch.data.captioning caption --data-dir D --model-path P
  python -m reed_tpu_torch.data.captioning embed --data-dir D --model-path P \\
      --layers 0 1 15 -1 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PROMPT = ("Describe this image concisely in one sentence, focusing on the "
          "main object and scene.")

# reference TEXT_Z_DIM_DICT (image/train.py:40-43)
TEXT_Z_DIMS = {"qwen2b": 1536, "qwen7b": 3584}


def mean_pool(hidden: np.ndarray) -> np.ndarray:
    """[T, D] token hidden states -> the [D] mean over the sequence
    (reference: captioning.py:106-150)."""
    hidden = np.asarray(hidden, np.float32)
    if hidden.ndim != 2:
        raise ValueError(f"hidden states must be [T, D], got {hidden.shape}")
    return hidden.mean(axis=0)


def build_messages(text: str) -> List[Dict]:
    """The chat-template message list of an (image, text) pair."""
    return [{"role": "user", "content": [{"type": "image"}, {"type": "text", "text": text}]}]


def layer_dir_name(prefix: str, k: int) -> str:
    """Hidden layer k -> its output subdirectory (the reference's
    text_embeds_qwen7b_l{0,1,15,last} layout)."""
    return f"{prefix}_l{'last' if k == -1 else k}"


def read_labels(data_dir: str) -> List:
    with open(os.path.join(data_dir, "dataset.json")) as f:
        return json.load(f)["labels"]


class QwenBackend:
    """Qwen2-VL through transformers on `device`: caption and embed
    images. Needs the weights under `model_path` and transformers."""

    def __init__(self, model_path: str, device: str = "cuda"):
        import torch
        from transformers import AutoProcessor, Qwen2VLForConditionalGeneration

        self.torch, self.device = torch, torch.device(device)
        self.model = Qwen2VLForConditionalGeneration.from_pretrained(
            model_path, torch_dtype=torch.float32).to(self.device).eval()
        self.processor = AutoProcessor.from_pretrained(model_path)

    def _inputs(self, text, img):
        inputs = self.processor(text=[text], images=[img], return_tensors="pt")
        return {k: v.to(self.device) for k, v in inputs.items()}

    def caption(self, img) -> Tuple[str, np.ndarray]:
        """(caption text, the pooled last hidden state of the prompt pass)."""
        text = self.processor.apply_chat_template(build_messages(PROMPT),
                                                  add_generation_prompt=True)
        inputs = self._inputs(text, img)
        with self.torch.no_grad():
            out = self.model.generate(**inputs, max_new_tokens=64, output_hidden_states=True,
                                      return_dict_in_generate=True)
        caption_ids = out.sequences[0][inputs["input_ids"].shape[1]:]
        caption_text = self.processor.decode(caption_ids, skip_special_tokens=True)
        hidden = out.hidden_states[0][-1][0].float().cpu().numpy()
        return caption_text, mean_pool(hidden)

    def embed(self, img, caption_text: str, layers: Sequence[int]) -> Dict[int, np.ndarray]:
        """The joint (image, caption) forward -> {layer: pooled state}."""
        inputs = self._inputs(self.processor.apply_chat_template(build_messages(caption_text)),
                              img)
        with self.torch.no_grad():
            out = self.model(**inputs, output_hidden_states=True)
        return {k: mean_pool(out.hidden_states[k][0].float().cpu().numpy()) for k in layers}


class StubBackend:
    """A deterministic stand-in for QwenBackend: the i-th caption is
    'caption i' with a pooled vector of i's; an embedding of layer k of
    caption i is i * 100 + k."""

    def __init__(self, dim: int = 16):
        self.dim = dim
        self.captioned = []

    def caption(self, img) -> Tuple[str, np.ndarray]:
        self.captioned.append(img.size)
        n = len(self.captioned)
        return f"caption {n}", np.full((self.dim,), float(n), np.float32)

    def embed(self, img, caption_text: str, layers: Sequence[int]) -> Dict[int, np.ndarray]:
        seed = int(caption_text.split()[-1])
        return {k: np.full((self.dim,), float(seed * 100 + k), np.float32) for k in layers}


def _open_image(data_dir: str, fname: str):
    from PIL import Image

    return Image.open(os.path.join(data_dir, "images", fname))


def caption(data_dir: str, model_path: Optional[str] = None, out_subdir: str = "captions",
            embed_subdir: str = "text_embeds_qwen2b_last", limit: Optional[int] = None,
            backend=None, device: str = "cuda"):
    """Stage 1 (reference: captioning.py:48-150): captions/<stem>.txt and
    <embed_subdir>/<stem>.npy for each image of dataset.json."""
    backend = backend if backend is not None else QwenBackend(model_path, device)
    os.makedirs(os.path.join(data_dir, out_subdir), exist_ok=True)
    os.makedirs(os.path.join(data_dir, embed_subdir), exist_ok=True)
    for i, (fname, _) in enumerate(read_labels(data_dir)):
        if limit is not None and i >= limit:
            break
        caption_text, pooled = backend.caption(_open_image(data_dir, fname))
        stem = os.path.splitext(fname)[0]
        with open(os.path.join(data_dir, out_subdir, stem + ".txt"), "w") as f:
            f.write(caption_text)
        np.save(os.path.join(data_dir, embed_subdir, stem + ".npy"), pooled)


def embed(data_dir: str, model_path: Optional[str] = None,
          layers: Sequence[int] = (0, 1, 15, -1), caption_subdir: str = "captions",
          prefix: str = "text_embeds_qwen7b", limit: Optional[int] = None, backend=None,
          device: str = "cuda"):
    """Stage 2 (reference: captioning_embedding.py:107-152): the joint
    (image, caption) forward, the selected hidden layers mean-pooled into
    <prefix>_l{k}/<stem>.npy."""
    backend = backend if backend is not None else QwenBackend(model_path, device)
    dirs = {k: os.path.join(data_dir, layer_dir_name(prefix, k)) for k in layers}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for i, (fname, _) in enumerate(read_labels(data_dir)):
        if limit is not None and i >= limit:
            break
        stem = os.path.splitext(fname)[0]
        with open(os.path.join(data_dir, caption_subdir, stem + ".txt")) as f:
            caption_text = f.read().strip()
        pooled = backend.embed(_open_image(data_dir, fname), caption_text, list(layers))
        for k, vec in pooled.items():
            np.save(os.path.join(dirs[k], stem + ".npy"), vec)


def main(argv=None):
    parser = argparse.ArgumentParser("reed_tpu_torch.data.captioning")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in ("caption", "embed"):
        p = sub.add_parser(name)
        p.add_argument("--data-dir", required=True)
        p.add_argument("--model-path", required=True)
        p.add_argument("--limit", type=int, default=None)
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
        if name == "embed":
            p.add_argument("--layers", type=int, nargs="+", default=[0, 1, 15, -1])
    args = parser.parse_args(argv)
    if args.cmd == "caption":
        caption(args.data_dir, args.model_path, limit=args.limit, device=args.device)
    else:
        embed(args.data_dir, args.model_path, layers=args.layers, limit=args.limit,
              device=args.device)


if __name__ == "__main__":
    main()
