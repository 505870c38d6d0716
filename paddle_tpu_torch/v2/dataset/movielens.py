"""Movielens ml-1m reader creators (reference dataset/movielens.py:
ml-1m.zip holding ml-1m/{movies,users,ratings}.dat with '::'-separated
fields — movies '(YYYY)' title suffix stripped by regex, category and
title-word dicts built from the corpus, ratings rescaled r*2-5, train/
test split by a seeded random ratio — movielens.py:100-160 semantics).

Each record: [uid, gender(0/1), age_index, job_id, movie_id,
[category ids], [title word ids], [rating]].

fetch() synthesises a REAL-FORMAT zip from the deterministic corpus;
real ml-1m.zip files decode through the same parser.
"""

import os
import random
import re
import zipfile

from . import common

__all__ = [
    "train", "test", "max_user_id", "max_movie_id", "max_job_id",
    "age_table", "movie_categories", "get_movie_title_dict", "fetch",
    "user_info", "movie_info", "convert",
]

age_table = [1, 18, 25, 35, 45, 50, 56]

_N_USERS, _N_MOVIES, _N_JOBS = 60, 80, 12
_CATS = ["Action", "Comedy", "Drama", "Horror", "Romance", "Sci-Fi",
         "Thriller", "War", "Musical", "Mystery"]
_TITLE_POOL = ["the", "of", "night", "day", "return", "story", "last",
               "first", "dark", "light", "lost", "city", "king", "man",
               "woman", "dream", "shadow", "river", "mountain", "sky"]
N_RATINGS = 640
_TEST_RATIO = 0.1  # reference __reader__ default

_META = {}
_SYNTH_CACHE = []


def _path():
    return os.path.join(common.DATA_HOME, "movielens", "ml-1m.zip")


def _synthetic_dats():
    if _SYNTH_CACHE:
        return _SYNTH_CACHE[0]
    rng = common.rng_for("movielens", "corpus")
    movies = []
    for mid in range(1, _N_MOVIES + 1):
        n_words = int(rng.randint(1, 4))
        words = [_TITLE_POOL[rng.randint(len(_TITLE_POOL))]
                 for _ in range(n_words)]
        title = " ".join(w.capitalize() for w in words)
        year = 1970 + int(rng.randint(0, 35))
        cats = sorted({_CATS[rng.randint(len(_CATS))]
                       for _ in range(rng.randint(1, 4))})
        movies.append("%d::%s (%d)::%s" % (mid, title, year, "|".join(cats)))
    users = []
    for uid in range(1, _N_USERS + 1):
        gender = "M" if rng.rand() < 0.5 else "F"
        age = age_table[rng.randint(len(age_table))]
        job = int(rng.randint(0, _N_JOBS))
        users.append("%d::%s::%d::%d::%05d" % (uid, gender, age, job, 10000))
    ratings = []
    for _ in range(N_RATINGS):
        uid = int(rng.randint(1, _N_USERS + 1))
        mid = int(rng.randint(1, _N_MOVIES + 1))
        r = 1 + ((uid % 2) == (mid % 2)) * 3 + int(rng.randint(0, 2))
        ratings.append("%d::%d::%d::%d" % (uid, mid, r, 978300000))
    _SYNTH_CACHE.append((movies, users, ratings))
    return _SYNTH_CACHE[0]


def fetch():
    path = _path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    movies, users, ratings = _synthetic_dats()
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w") as z:
        z.writestr("ml-1m/movies.dat", "\n".join(movies) + "\n")
        z.writestr("ml-1m/users.dat", "\n".join(users) + "\n")
        z.writestr("ml-1m/ratings.dat", "\n".join(ratings) + "\n")
    os.replace(tmp, path)
    return path


def _dat_lines(member):
    path = _path()
    if os.path.exists(path):
        with zipfile.ZipFile(path) as z:
            with z.open("ml-1m/%s" % member) as f:
                for line in f.read().decode("latin1").splitlines():
                    yield line
    else:
        movies, users, ratings = _synthetic_dats()
        for line in {"movies.dat": movies, "users.dat": users,
                     "ratings.dat": ratings}[member]:
            yield line


def _meta():
    """Parse movies.dat/users.dat exactly like the reference
    __initialize_meta_info__ (title year stripped, dicts from corpus)."""
    key = (_path(), os.path.exists(_path()))
    if key in _META:
        return _META[key]
    pattern = re.compile(r"^(.*)\((\d+)\)$")
    movie_info, title_words, cat_set = {}, set(), set()
    for line in _dat_lines("movies.dat"):
        movie_id, title, categories = line.strip().split("::")
        cats = categories.split("|")
        cat_set.update(cats)
        title = pattern.match(title).group(1)
        movie_info[int(movie_id)] = (cats, title)
        for w in title.split():
            title_words.add(w.lower())
    title_dict = {w: i for i, w in enumerate(sorted(title_words))}
    cat_dict = {c: i for i, c in enumerate(sorted(cat_set))}
    user_info = {}
    for line in _dat_lines("users.dat"):
        uid, gender, age, job, _zip = line.strip().split("::")
        user_info[int(uid)] = (
            0 if gender == "M" else 1,
            age_table.index(int(age)),
            int(job),
        )
    _META[key] = (movie_info, title_dict, cat_dict, user_info)
    return _META[key]


def _reader_creator(is_test, rand_seed=0, test_ratio=_TEST_RATIO):
    def reader():
        movie_info, title_dict, cat_dict, user_info = _meta()
        rand = random.Random(x=rand_seed)
        for line in _dat_lines("ratings.dat"):
            if (rand.random() < test_ratio) != is_test:
                continue
            uid, mov_id, rating, _ts = line.strip().split("::")
            uid, mov_id = int(uid), int(mov_id)
            rating = float(rating) * 2 - 5.0
            gender, age, job = user_info[uid]
            cats, title = movie_info[mov_id]
            yield (uid, gender, age, job, mov_id,
                   [cat_dict[c] for c in cats],
                   [title_dict[w.lower()] for w in title.split()],
                   [rating])

    return reader


def train():
    return _reader_creator(is_test=False)


def test():
    return _reader_creator(is_test=True)


def max_user_id():
    return max(_meta()[3])


def max_movie_id():
    return max(_meta()[0])


def max_job_id():
    return max(j for _, _, j in _meta()[3].values())


def movie_categories():
    return dict(_meta()[2])


def get_movie_title_dict():
    return dict(_meta()[1])


def user_info():
    """{uid: (gender01, age_index, job)} (reference user_info returns
    UserInfo objects; the tuple carries the same .value() fields)."""
    return dict(_meta()[3])


def movie_info():
    """{movie_id: (categories, title)} (reference movie_info)."""
    return dict(_meta()[0])


def convert(path):
    common.convert(path, train(), 256, "movielens_train")
    common.convert(path, test(), 256, "movielens_test")
