"""The text and speaker part of the RADTTS dataset: filelist rows, the
speaker lookup table, the speaker and duration filters, and text encoding.
Serving needs only this part (the speaker ids a checkpoint was trained
with, and the text frontend its config names); audio, pYIN, the attention
priors and the lmdb caches belong to the training data pipeline and are
not here.

A copy of the JAX package's radtts_tpu/data/dataset.py:Data (its load_data,
create_speaker_lookup_table, filters, speaker_map, get_speaker_id and
get_text) and data_factory.
"""

import os

import numpy as np

from radtts_tpu_torch.text.processing import TextProcessing, resolve_asset


class Data:
    def __init__(self, datasets, symbol_set, cleaner_names, heteronyms_path,
                 phoneme_dict_path, p_phoneme, handle_phoneme="word",
                 handle_phoneme_ambiguous="ignore", speaker_ids=None,
                 include_speakers=None, prepend_space_to_text=True,
                 append_space_to_text=True, add_bos_eos_to_text=False,
                 dur_min=None, dur_max=None,
                 combine_speaker_and_emotion=False, speaker_map=None,
                 **audio_and_cache_settings):
        self.combine_speaker_and_emotion = combine_speaker_and_emotion
        self.data = self.load_data(datasets)
        self.tp = TextProcessing(
            symbol_set, cleaner_names, heteronyms_path, phoneme_dict_path,
            p_phoneme=p_phoneme, handle_phoneme=handle_phoneme,
            handle_phoneme_ambiguous=handle_phoneme_ambiguous,
            prepend_space_to_text=prepend_space_to_text,
            append_space_to_text=append_space_to_text,
            add_bos_eos_to_text=add_bos_eos_to_text)

        # the table is built from every row BEFORE the filters, so a
        # filtered-out speaker keeps its place and the ids do not shift
        if speaker_ids is None or speaker_ids == "":
            self.speaker_ids = self.create_speaker_lookup_table(self.data)
        else:
            self.speaker_ids = speaker_ids

        print("Number of files", len(self.data))
        if include_speakers is not None:
            for (speaker_set, include) in include_speakers:
                self.filter_by_speakers_(speaker_set, include)
            print("Number of files after speaker filtering", len(self.data))
        if dur_min is not None and dur_max is not None:
            self.filter_by_duration_(dur_min, dur_max)
            print("Number of files after duration filtering", len(self.data))
        self.speaker_map = speaker_map

    def load_data(self, datasets, split="|"):
        """Rows `audio|text|speaker` or `audio|text|speaker|emotion|
        duration` of every filelist; the audio paths are kept, not read."""
        dataset = []
        for dset_dict in datasets.values():
            wav_folder_prefix = os.path.join(dset_dict["basedir"],
                                             dset_dict["audiodir"])
            filelist_path = resolve_asset(
                os.path.join(dset_dict["basedir"], dset_dict["filelist"]))
            with open(filelist_path, encoding="utf-8") as f:
                rows = [line.strip().split(split) for line in f]
            for d in rows:
                emotion = "other" if len(d) == 3 else d[3]
                duration = -1 if len(d) == 3 else d[4]
                speaker = (d[2] + "-" + emotion
                           if self.combine_speaker_and_emotion else d[2])
                dataset.append({
                    "audiopath": os.path.join(wav_folder_prefix, d[0]),
                    "text": d[1],
                    "speaker": speaker,
                    "emotion": emotion,
                    "duration": float(duration),
                })
        return dataset

    def filter_by_speakers_(self, speakers, include=True):
        if include:
            self.data = [x for x in self.data if x["speaker"] in speakers]
        else:
            self.data = [x for x in self.data
                         if x["speaker"] not in speakers]

    def filter_by_duration_(self, dur_min, dur_max):
        self.data = [x for x in self.data
                     if x["duration"] == -1
                     or dur_min <= x["duration"] <= dur_max]

    def create_speaker_lookup_table(self, data):
        speaker_ids = np.sort(np.unique([x["speaker"] for x in data]))
        d = {speaker_ids[i]: i for i in range(len(speaker_ids))}
        print("Number of speakers:", len(d))
        return d

    def get_speaker_id(self, speaker):
        if self.speaker_map is not None and speaker in self.speaker_map:
            speaker = self.speaker_map[speaker]
        return np.int64(self.speaker_ids[speaker])

    def get_text(self, text):
        return np.asarray(self.tp.encode_text(text), dtype=np.int64)


def data_factory(data_config, files_key, speaker_ids=None):
    """Data over data_config[files_key] with the rest of data_config as
    its settings."""
    ignore_keys = ("training_files", "validation_files")
    return Data(data_config[files_key],
                **{k: v for k, v in data_config.items()
                   if k not in ignore_keys},
                speaker_ids=speaker_ids)
