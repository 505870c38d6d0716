"""Dataset batching/pickling utilities (reference
python/paddle/utils/preprocess_util.py): turn a directory of raw samples
into shuffled pickled batch files plus train/test list files — the wire
format the legacy image configs consumed."""

from __future__ import annotations

import collections
import math
import os
import pickle
import random

__all__ = [
    "save_file", "save_list", "exclude_pattern", "list_dirs",
    "list_images", "list_files", "get_label_set_from_dir", "Label",
    "Dataset", "DataBatcher", "DatasetCreater",
]


def save_file(data, filename):
    """Pickle `data` to `filename` (highest protocol)."""
    with open(filename, "wb") as f:
        pickle.dump(data, f, pickle.HIGHEST_PROTOCOL)


def save_list(l, outfile):
    """Write one entry per line."""
    with open(outfile, "w") as f:
        for item in l:
            f.write("%s\n" % item)


def exclude_pattern(f):
    """Hidden/system entries are excluded from directory listings."""
    return f.startswith(".") or f.startswith("_")


def list_dirs(path):
    return sorted(
        d
        for d in os.listdir(path)
        if os.path.isdir(os.path.join(path, d)) and not exclude_pattern(d)
    )


def list_images(path, exts=set(["jpg", "png", "bmp", "jpeg"])):
    return sorted(
        f
        for f in os.listdir(path)
        if os.path.isfile(os.path.join(path, f))
        and not exclude_pattern(f)
        and f.rsplit(".", 1)[-1].lower() in exts
    )


def list_files(path):
    return sorted(
        f
        for f in os.listdir(path)
        if os.path.isfile(os.path.join(path, f)) and not exclude_pattern(f)
    )


def get_label_set_from_dir(path):
    """label name -> id, from the sub-directory names of a dataset laid
    out as path/<label>/<images>."""
    return {name: i for i, name in enumerate(list_dirs(path))}


class Label:
    """One label slot value."""

    def __init__(self, label, name):
        self.label = label
        self.name = name

    def convert_to_paddle_format(self):
        return int(self.label)

    def __hash__(self):
        return hash(self.label)


class Dataset:
    """A list of items, each a tuple of slots; every slot value provides
    convert_to_paddle_format()."""

    def __init__(self, data, keys):
        self.data = data
        self.keys = keys

    def check_valid(self):
        for d in self.data:
            assert len(d) == len(self.keys)

    def permute(self, key_id, num_per_batch):
        if key_id is None:
            self.uniform_permute()
        else:
            self.permute_by_key(key_id, num_per_batch)

    def uniform_permute(self):
        random.shuffle(self.data)

    def permute_by_key(self, key_id, num_per_batch):
        """Shuffle so the values of slot `key_id` are evenly spread over
        batches of num_per_batch (stratified batching)."""
        by_key = collections.defaultdict(list)
        for idx, item in enumerate(self.data):
            by_key[item[key_id].label].append(idx)
        for k in by_key:
            random.shuffle(by_key[k])
        per_key = int(math.ceil(num_per_batch / float(len(by_key))))
        if per_key < 2:
            raise Exception("The number of data in a batch is too small")
        permuted, cursor = [], collections.defaultdict(int)
        while len(permuted) < len(self.data):
            for k in by_key:
                lo = cursor[k]
                hi = min(lo + per_key, len(by_key[k]))
                permuted.extend(self.data[i] for i in by_key[k][lo:hi])
                cursor[k] = hi
        self.data = permuted


class DataBatcher:
    """Write pickled batch files + list files for train/test datasets."""

    def __init__(self, train_data, test_data, label_set):
        self.train_data = train_data
        self.test_data = test_data
        self.label_set = label_set
        self.num_per_batch = 5000
        assert self.train_data.keys == self.test_data.keys

    def create_batches_and_list(self, output_path, train_list_name,
                                test_list_name, label_set_name):
        train_list = self.create_batches(
            self.train_data, output_path, "train_", self.num_per_batch
        )
        test_list = self.create_batches(
            self.test_data, output_path, "test_", self.num_per_batch
        )
        save_list(train_list, os.path.join(output_path, train_list_name))
        save_list(test_list, os.path.join(output_path, test_list_name))
        save_file(self.label_set, os.path.join(output_path, label_set_name))

    def create_batches(self, data, output_path, prefix="",
                       num_data_per_batch=5000):
        data.check_valid()
        n_batches = int(
            math.ceil(len(data.data) / float(num_data_per_batch))
        )
        names = []
        for b in range(n_batches):
            name = os.path.join(output_path, prefix + "batch_%03d" % b)
            out = {k: [] for k in data.keys}
            for item in data.data[
                b * num_data_per_batch:(b + 1) * num_data_per_batch
            ]:
                for key, slot in zip(data.keys, item):
                    out[key].append(slot.convert_to_paddle_format())
            save_file(out, name)
            names.append(name)
        return names


class DatasetCreater(object):
    """Base for dataset creators: walks data_path/{train,test}/<label>/,
    builds Datasets via the subclass's create_dataset_from_dir, batches
    and writes meta. Subclasses implement create_dataset_from_dir /
    create_meta_file."""

    def __init__(self, data_path):
        self.data_path = data_path
        self.train_dir_name = "train"
        self.test_dir_name = "test"
        self.batch_dir_name = "batches"
        self.num_per_batch = 5000
        self.meta_filename = "batches.meta"
        self.train_list_name = "train.list"
        self.test_list_name = "test.list"
        self.label_set_name = "labels.pkl"
        self.output_path = os.path.join(self.data_path, self.batch_dir_name)
        self.overwrite = False

    def create_dataset_from_dir(self, path):
        raise NotImplementedError

    def create_meta_file(self, data):
        raise NotImplementedError

    def create_batches(self):
        train_path = os.path.join(self.data_path, self.train_dir_name)
        test_path = os.path.join(self.data_path, self.test_dir_name)
        out_path = self.output_path
        if os.path.exists(out_path) and not self.overwrite:
            return out_path
        os.makedirs(out_path, exist_ok=True)
        train_data = self.create_dataset_from_dir(train_path)
        test_data = self.create_dataset_from_dir(test_path)
        permute_key = getattr(self, "permute_key", None)
        key_id = (
            self.keys.index(permute_key)
            if permute_key and permute_key in getattr(self, "keys", [])
            else None
        )
        train_data.permute(key_id, self.num_per_batch)
        batcher = DataBatcher(
            train_data, test_data, get_label_set_from_dir(train_path)
        )
        batcher.num_per_batch = self.num_per_batch
        batcher.create_batches_and_list(
            out_path, self.train_list_name, self.test_list_name,
            self.label_set_name,
        )
        self.create_meta_file(train_data)
        return out_path
