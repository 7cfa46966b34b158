"""Config-driven datasets on the host, in numpy (the port's own copy of
``msmctts_tpu/data/datasets.py:39-554``): shape buckets, WAV I/O,
``BaseDataset``, the ``MelDataset`` that autoencoder training reads, the
``EmbDataset`` (SSL embeddings) that QS-TTS synthesizer training reads and the
``TTSDataset`` (text, durations, mel or emb) that acoustic-model training reads, with
the same YAML contract (parallel ``feature`` / ``dimension`` / ``frameshift``
/ ``padding_value`` lists, ``feature_path`` templates, book files, test-list
YAMLs, ``feature_stat`` normalization, random segment cropping) and the same
seeded order, so both stacks see the same batches. ``parse_cases`` reads
every plain .npy / .wav file of a batch in one call of the native reader
(``data/native.py``); the rest, and every file where that reader is not
available, is read with numpy and scipy.

Every batch is padded up to a bucket boundary from a fixed ladder, so the
set of distinct shapes the device sees stays small. Every frame bucket is a
multiple of 64, so any downsample/pred scale dividing 64 keeps shapes exact.
"""

from __future__ import annotations

import io
import os
import pickle
import random
import zipfile
from typing import Dict, List, Optional, Sequence

import numpy as np

from msmctts_tpu_torch.config import load_yaml
from msmctts_tpu_torch.registry import register_dataset

MIN_DATASET_SIZE = 3200

FRAME_BUCKETS = (64, 128, 192, 256, 384, 512, 768, 1024, 1280, 1536, 2048, 2432)
TEXT_BUCKETS = (16, 32, 48, 64, 96, 128, 192, 256)


def bucket_length(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    # round up to the bucket granularity past the ladder
    step = buckets[0]
    return ((n + step - 1) // step) * step


def save_wav(path: str, wav: np.ndarray, sample_rate: int):
    """float waveform in [-1, 1] -> 16-bit PCM WAV."""
    from scipy.io import wavfile

    wav = np.asarray(wav, np.float32).squeeze()
    wav = np.clip(wav, -1.0, 1.0)
    wavfile.write(path, sample_rate, (wav * 32767.0).astype(np.int16))


def load_wav(path_or_buf, target_sr: Optional[int] = None) -> np.ndarray:
    """Read a WAV file to float32 [-1, 1] mono [T]."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path_or_buf)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    if target_sr is not None and sr != target_sr:
        raise ValueError(f"sample rate mismatch: file {sr} != config {target_sr}")
    return data


def feature_normalize(feature, stat: dict, denormalize: bool = False):
    """minmax + scale/shift normalization."""
    feature = np.asarray(feature, np.float32)
    if denormalize:
        feature = (feature - stat.get("shift", 0.0)) / stat.get("scale", 1.0)
    if stat.get("method") == "minmax":
        lo = np.asarray(stat["min"])
        hi = np.asarray(stat["max"])
        rng = hi - lo
        feature = (feature - lo) / rng if not denormalize else rng * feature + lo
    if not denormalize:
        feature = feature * stat.get("scale", 1.0) + stat.get("shift", 0.0)
    return feature.astype(np.float32)


def align_features(feat_dict: dict, fs_dict: dict) -> dict:
    """Trim co-sequences to a common duration and the frameshift LCM."""
    seq = {k: v for k, v in feat_dict.items() if k in fs_dict and fs_dict[k] > 0}
    if not seq:
        return feat_dict
    durations = {k: float(v.shape[0]) * fs_dict[k] for k, v in seq.items()}
    if max(durations.values()) / max(min(durations.values()), 1e-9) >= 1.1:
        raise RuntimeError(f"features badly misaligned: {durations}")
    min_dur = min(durations.values())
    fs_lcm = np.lcm.reduce([fs_dict[k] for k in seq])
    clipped = min_dur - min_dur % fs_lcm
    for k in seq:
        feat_dict[k] = seq[k][: int(clipped / fs_dict[k])]
    return feat_dict


class BaseDataset:
    def __init__(
        self,
        id_list,
        feature: List[str],
        samplerate: int,
        dimension: List[int],
        frameshift: List[Optional[int]],
        feature_path=None,
        feature_stat=None,
        padding_value=None,
        segment_length: int = -1,
        pre_load: bool = False,
        seed: int = 1234,
        training: bool = True,
    ):
        self.samplerate = samplerate
        self.feature = list(feature)
        self.dimension = {f: d for f, d in zip(feature, dimension) if d and d > 0}
        self.frameshift = {
            f: s for f, s in zip(feature, frameshift) if s is not None and s > 0
        }
        if padding_value is not None:
            self.padding_value = {f: v for f, v in zip(feature, padding_value)}
        else:
            self.padding_value = {f: 0 for f in feature}
        self.segment_length = segment_length
        self.pre_load = pre_load
        self.training = training
        self.rng = random.Random(seed)
        self.dataset: Dict = {}
        self._zip_handles: Dict[str, zipfile.ZipFile] = {}

        self.feature_stat = {}
        if feature_stat is not None:
            self.feature_stat = {
                f: load_yaml(s) for f, s in zip(feature, feature_stat) if s is not None
            }

        self.id_list = self._prepare(id_list, feature_path)
        if self.pre_load:
            self._preload()
        if self.training:
            self.rng.shuffle(self.id_list)

    # ------------------------------------------------------------------ ids
    def _prepare(self, id_list_file, feature_path):
        if isinstance(id_list_file, (tuple, list)) and id_list_file and os.path.splitext(
            str(id_list_file[0])
        )[1] in (".list", ".yaml", ".txt"):
            ids = []
            for i, lf in enumerate(id_list_file):
                paths = [p[i] for p in feature_path] if feature_path else None
                ids += self._prepare(lf, paths)
            return ids

        if isinstance(id_list_file, str) and ".yaml" in id_list_file:
            # test-list yaml: id -> {feat: path or inline string}
            data = load_yaml(id_list_file)
            ids = sorted(data.keys())
            for case_id in ids:
                for name, item in data[case_id].items():
                    self.dataset[((case_id,), name)] = item
            return [(i,) for i in ids]

        with open(id_list_file) as f:
            ids = [tuple(x.strip().split()) for x in f if x.strip()]
        for feat, path in zip(self.feature, feature_path):
            if isinstance(path, str) and os.path.isfile(path):
                self._parse_book(path, ids, feat)
                continue
            for attrs in ids:
                self.dataset[(attrs, feat)] = path.format(*attrs)
        return ids

    def _parse_book(self, path, id_list, feat):
        ext = os.path.splitext(path)[-1]
        if ext in (".list", ".txt"):
            book = {}
            with open(path) as f:
                for line in f:
                    segs = line.strip().split("|")
                    if not segs or not segs[0]:
                        continue
                    arrays = []
                    for payload in segs[1:]:
                        arr = np.array(
                            [
                                float(tok)
                                if "_" not in tok
                                else [float(x) for x in tok.split("_")]
                                for tok in payload.split(" ")
                                if tok
                            ]
                        )
                        arrays.append(arr)
                    book[segs[0]] = arrays if len(arrays) > 1 else arrays[0]
        elif ext == ".pkl":
            with open(path, "rb") as f:
                book = pickle.load(f)
        elif ext == ".yaml":
            book = load_yaml(path)
        else:
            raise ValueError(f"unknown book format: {path}")
        for attrs in id_list:
            key = next(a for a in attrs if a in book)
            self.dataset[(attrs, feat)] = np.asarray(book[key])

    # ------------------------------------------------------------ file I/O
    def _open_maybe_zip(self, path):
        if not os.path.isfile(path) and ":" in path:
            file_zip, member = path.split(":", 1)
            if file_zip not in self._zip_handles:
                self._zip_handles[file_zip] = zipfile.ZipFile(file_zip, "r")
            with self._zip_handles[file_zip].open(member, "r") as zf:
                return io.BytesIO(zf.read())
        return path

    def parse_file(self, path, dimension=None):
        # 'archive.zip:member.npy' paths take the member's extension
        name = path.split(":", 1)[1] if (":" in path and not os.path.isfile(path)) else path
        ext = os.path.splitext(name)[-1]
        src = self._open_maybe_zip(path)
        if ext == ".npy":
            return np.load(src).astype(np.float32)
        if ext == ".wav":
            return load_wav(src, self.samplerate)[:, None]
        if ext == ".pt":
            import torch

            data = torch.load(src, map_location="cpu").squeeze(0).numpy()
            if dimension is not None and data.shape[0] == dimension:
                data = data.T
            return data
        if ext in (".dat", ".mgc", ".ap"):
            raw = np.fromfile(src, dtype=np.float32) if isinstance(src, str) else np.frombuffer(
                src.read(), dtype=np.float32
            )
            return raw.reshape(-1, dimension or 1)
        raise ValueError(f"unknown feature file extension: {path}")

    @staticmethod
    def parse_string(string, dimension=None):
        if "_" in string:
            string = string.replace("_", " ")
        x = np.fromstring(string, sep=" ")
        if dimension is not None:
            x = x.reshape(len(x) // dimension, dimension)
        return x

    def _preload(self):
        from concurrent.futures import ThreadPoolExecutor

        keys = [k for k, v in self.dataset.items() if isinstance(v, str) and os.path.isfile(v.split(":")[0])]
        with ThreadPoolExecutor(max_workers=max(2, os.cpu_count() // 2)) as ex:
            futs = {
                k: ex.submit(self.parse_file, self.dataset[k], self.dimension.get(k[1]))
                for k in keys
            }
            for k, f in futs.items():
                self.dataset[k] = f.result()

    # --------------------------------------------------------------- cases
    def __len__(self):
        if self.training:
            return max(MIN_DATASET_SIZE, len(self.id_list))
        return len(self.id_list)

    def __getitem__(self, index):
        return self.parse_case(index % len(self.id_list))

    def parse_cases(self, indices):
        """The cases of a batch, every plain .npy / .wav file of them read in
        one GIL-free call of the native reader (``native.read_batch``), the
        loader's collate path (``msmctts_tpu/data/datasets.py:297-338``).
        Zip members, .pt, .dat and inline strings keep the per-file path, as
        does every file of a batch the native parser rejects; without the
        native reader every file does."""
        from msmctts_tpu_torch.data import native

        preloaded = None
        if native.native_available():
            paths, kinds, seen = [], [], set()
            for index in indices:
                case_id = self.id_list[index % len(self.id_list)]
                for feat in self.feature:
                    v = self.dataset.get((case_id, feat))
                    if not isinstance(v, str) or v in seen:
                        continue
                    ext = os.path.splitext(v)[-1]
                    if ext not in (".npy", ".wav") or not os.path.isfile(v):
                        continue
                    seen.add(v)
                    paths.append(v)
                    kinds.append(0 if ext == ".npy" else 1)
            if paths:
                try:
                    arrays, srs = native.read_batch(paths, kinds)
                except IOError:  # e.g. an npy the C++ parser rejects: this batch reads file by file
                    arrays = None
                if arrays is not None:
                    preloaded = {}
                    for p, k, a, sr in zip(paths, kinds, arrays, srs):
                        if k == 1:
                            if self.samplerate and sr != self.samplerate:
                                raise ValueError(f"sample rate mismatch: file {sr} != config {self.samplerate}")
                            a = a[:, None]
                        preloaded[p] = a
        return [self.parse_case(i % len(self.id_list), preloaded) for i in indices]

    def _load_path(self, path, dimension, preloaded):
        if preloaded is not None and path in preloaded:
            return preloaded[path]
        return self.parse_file(path, dimension)

    def parse_case(self, index, preloaded=None):
        case_id = self.id_list[index]
        data = {
            feat: self.dataset[(case_id, feat)]
            for feat in self.feature
            if (case_id, feat) in self.dataset
        }

        # random segment crop on the coarsest feature
        dur, dur_s = -1, 0
        if self.training and self.segment_length > 0 and self.frameshift:
            dur = self.segment_length
            coarsest = max(self.frameshift, key=self.frameshift.get)
            item = data[coarsest]
            if isinstance(item, str):
                item = self._load_path(item, self.dimension.get(coarsest), preloaded)
                data[coarsest] = item
            n_frames = item.shape[0]
            max_start = max(0, n_frames - int(np.ceil(dur / self.frameshift[coarsest])))
            dur_s = float(self.rng.randint(0, max_start)) * self.frameshift[coarsest]

        for key, feature in data.items():
            start, length = 0, -1
            if key in self.frameshift:
                start = int(dur_s / self.frameshift[key])
                length = int(dur / self.frameshift[key]) if dur > 0 else -1
            if isinstance(feature, str):
                feature = (
                    self._load_path(feature, self.dimension.get(key), preloaded)
                    if os.path.isfile(feature.split(":")[0])
                    else self.parse_string(feature, self.dimension.get(key))
                )
            feature = np.asarray(feature)
            end = start + length if length > 0 else None
            feature = feature[start:end]
            if key in self.feature_stat:
                feature = feature_normalize(feature, self.feature_stat[key])
            data[key] = feature

        if not self.training:
            data["_id"] = index
        return data

    # ------------------------------------------------------------- collate
    @staticmethod
    def _pad_to(arr, target_len, value):
        pad = target_len - arr.shape[0]
        if pad <= 0:
            return arr[:target_len]
        width = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
        return np.pad(arr, width, constant_values=value)


@register_dataset("MelDataset")
class MelDataset(BaseDataset):
    """mel (+wav) pairs for autoencoder training."""

    frame_buckets = FRAME_BUCKETS

    def parse_case(self, index, preloaded=None):
        data = super().parse_case(index, preloaded)
        return align_features(data, self.frameshift)

    def collate_fn(self, batch):
        mel_fs = self.frameshift.get("mel", 1)
        lengths = np.array([b["mel"].shape[0] for b in batch], np.int32)
        T = bucket_length(int(lengths.max()), self.frame_buckets)
        out = {
            "mel": np.stack(
                [self._pad_to(b["mel"], T, self.padding_value.get("mel", 0)) for b in batch]
            ).astype(np.float32),
            "mel_length": lengths,
        }
        if "wav" in batch[0]:
            Tw = T * mel_fs
            wav = np.stack(
                [
                    self._pad_to(np.squeeze(b["wav"], -1) if b["wav"].ndim == 2 else b["wav"], Tw, 0.0)
                    for b in batch
                ]
            ).astype(np.float32)
            out["wav"] = wav
            out["wav_length"] = lengths * mel_fs
        if "_id" in batch[0]:
            out["_id"] = np.array([b["_id"] for b in batch])
        return out


@register_dataset("EmbDataset")
class EmbDataset(BaseDataset):
    """SSL embeddings (+ mel / wav / pitch / energy) for QS-TTS synthesizer
    training and analysis-synthesis (``msmctts_tpu/data/datasets.py:433-478``):
    features aligned on their frameshifts; ``emb``, ``mel``, ``pitch`` and
    ``energy`` padded to the emb axis's frame bucket, ``wav`` to that
    bucket x the emb frameshift."""

    frame_buckets = FRAME_BUCKETS

    def parse_case(self, index, preloaded=None):
        data = super().parse_case(index, preloaded)
        return align_features(data, self.frameshift)

    def collate_fn(self, batch):
        emb_fs = self.frameshift.get("emb", 1)
        lengths = np.array([b["emb"].shape[0] for b in batch], np.int32)
        T = bucket_length(int(lengths.max()), self.frame_buckets)
        out = {
            "emb": np.stack(
                [self._pad_to(b["emb"], T, self.padding_value.get("emb", 0)) for b in batch]
            ).astype(np.float32),
            "emb_length": lengths,
        }
        for name in ("mel", "pitch", "energy"):
            if name in batch[0]:
                arrs = [np.atleast_2d(b[name].reshape(b[name].shape[0], -1)) for b in batch]
                out[name] = np.stack(
                    [self._pad_to(a, T, self.padding_value.get(name, 0)) for a in arrs]
                ).astype(np.float32)
        if "wav" in batch[0]:
            Tw = T * emb_fs
            out["wav"] = np.stack(
                [
                    self._pad_to(np.squeeze(b["wav"], -1) if b["wav"].ndim == 2 else b["wav"], Tw, 0.0)
                    for b in batch
                ]
            ).astype(np.float32)
            out["wav_length"] = lengths * emb_fs
        if "_id" in batch[0]:
            out["_id"] = np.array([b["_id"] for b in batch])
        return out


@register_dataset("TTSDataset")
class TTSDataset(BaseDataset):
    """text/dur/mel for acoustic-model training (tts_dataset.py:10-99).
    Durations given in seconds (fewer than one per 100 mel frames) are
    rescaled to frames, each rounded with its rounding error carried to the
    next; the last duration then absorbs the difference between the mel
    frames and the durations' sum, which may be at most 5 frames. Text is
    padded to a text bucket, frame features to a frame bucket."""

    frame_buckets = FRAME_BUCKETS
    text_buckets = TEXT_BUCKETS

    def parse_case(self, index, preloaded=None):
        data = super().parse_case(index, preloaded)
        data = align_features(data, self.frameshift)

        text = data["text"]
        if text.ndim == 2 and text.shape[1] == 1:
            text = text[:, 0]
        data["text"] = text
        text_length = len(text)

        if "dur" in data:
            durs = np.asarray(data["dur"], np.float64)
            if durs.ndim == 2:
                durs = durs[:, 0]
            if len(durs) != text_length:
                raise ValueError(f"{self.id_list[index]}: dur {len(durs)} vs text {text_length}")
            if "mel" in data:
                n_frames = data["mel"].shape[0]
                if n_frames / max(durs.sum(), 1e-9) > 100:
                    # durations in seconds -> frames, carrying the rounding error
                    durs = durs * self.samplerate / self.frameshift["mel"]
                    for i in range(len(durs)):
                        int_f = round(durs[i])
                        if i < len(durs) - 1:
                            durs[i + 1] += durs[i] - int_f
                        durs[i] = int_f
                shift = n_frames - durs.sum()
                if not -5 <= shift <= 5:
                    raise ValueError(f"{self.id_list[index]}: mel {n_frames} vs dur {durs.sum()}")
                durs[-1] += shift
            data["dur"] = durs.astype(np.float32)
        return data

    def collate_fn(self, batch):
        out = {}
        text_lengths = np.array([b["text"].shape[0] for b in batch], np.int32)
        Lt = bucket_length(int(text_lengths.max()), self.text_buckets)
        out["text_length"] = text_lengths
        for name in ("text", "tone", "dur"):
            if name in batch[0]:
                out[name] = np.stack([self._pad_to(b[name], Lt, self.padding_value.get(name, 0)) for b in batch])
        out["text"] = out["text"].astype(np.int32)

        for name in ("mel", "emb", "wav", "pitch", "energy"):
            if name not in batch[0]:
                continue
            lengths = np.array([b[name].shape[0] for b in batch], np.int32)
            if name == "wav":
                frame_fs = self.frameshift.get("mel", self.frameshift.get("emb", 1))
                T = bucket_length(int(lengths.max()), tuple(b * frame_fs for b in self.frame_buckets))
            else:
                T = bucket_length(int(lengths.max()), self.frame_buckets)
            arrs = [b[name] for b in batch]
            arrs = [np.squeeze(a, -1) if (name == "wav" and a.ndim == 2) else a for a in arrs]
            out[name] = np.stack([self._pad_to(a, T, self.padding_value.get(name, 0)) for a in arrs]).astype(np.float32)
            if name in ("mel", "emb", "wav"):
                out[name + "_length"] = lengths
        if "_id" in batch[0]:
            out["_id"] = np.array([b["_id"] for b in batch])
        return out
