"""The clip pools and the stream of visits are the same for the same recipe and seed."""

import hashlib
import os

import pytest

from benchmark.harness import corpus, manifest

RECIPES = {name: manifest.merged(manifest.load_json(manifest.traffic_path(name)),
                                 manifest.load_json(manifest.traffic_path(name)).get("dry_run"))
           ["corpus"] for name in ("kinetics_packed", "ssv2_packed")}


def test_clip_plans_hold_each_geometry_in_its_share():
    for name in ("kinetics_packed", "ssv2_packed"):
        recipe = manifest.load_json(manifest.traffic_path(name))["corpus"]
        plan = corpus.clip_plan(recipe)
        assert len(plan) == recipe["clips"]
        total = sum(g["weight"] for g in recipe["geometries"])
        for k, g in enumerate(recipe["geometries"]):
            share = sum(1 for c in plan if c["geometry"] == k) / len(plan)
            assert abs(share - g["weight"] / total) <= 1 / len(plan)
        lo, hi = recipe["frames"]
        assert all(lo <= c["frames"] <= hi for c in plan)
        assert plan == corpus.clip_plan(recipe)


def test_kinetics_pool_is_ten_landscape_clips_and_two_rotated():
    plan = corpus.clip_plan(manifest.load_json(manifest.traffic_path("kinetics_packed"))["corpus"])
    assert sum(1 for c in plan if c["rotate"] and c["size"] == [256, 340]) == 2
    assert sum(1 for c in plan if not c["rotate"] and c["size"] == [340, 256]) == 10
    assert {c["frames"] for c in plan} == {250}


def _digest(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def test_a_pool_is_built_the_same_twice(tmp_path):
    recipe = RECIPES["kinetics_packed"]
    a = corpus.build_pool(recipe, cache_dir=str(tmp_path / "a"))
    b = corpus.build_pool(recipe, cache_dir=str(tmp_path / "b"))
    assert [c["frames"] for c in a["clips"]] == [c["frames"] for c in b["clips"]] == [34] * 4
    assert [(c["width"], c["height"]) for c in a["clips"]] == [(86, 64)] * 2 + [(64, 86), (86, 64)]
    assert [_digest(c["path"]) for c in a["clips"]] == [_digest(c["path"]) for c in b["clips"]]
    # a second call reuses the pool
    mtime = os.path.getmtime(a["clips"][0]["path"])
    assert corpus.build_pool(recipe, cache_dir=str(tmp_path / "a"))["dir"] == a["dir"]
    assert os.path.getmtime(a["clips"][0]["path"]) == mtime


def test_stream_offers_every_seed_the_same_geometries_in_another_order():
    pool = {"clips": [{"name": f"c{i}", "frames": 10 + i, "geometry": 0 if i < 5 else 1,
                       "path": f"/p/c{i}"} for i in range(6)]}
    s1 = corpus.plan_stream(pool, 2 ** 31 + 7, warmup=4, visits=40)
    s2 = corpus.plan_stream(pool, 2 ** 31 + 7, warmup=4, visits=40)
    s3 = corpus.plan_stream(pool, 5, warmup=4, visits=40)
    assert [v["name"] for v in s1] == [v["name"] for v in s2] != [v["name"] for v in s3]
    assert [v["geometry"] for v in s1] == [v["geometry"] for v in s3]
    assert [v["geometry"] for v in s1[:6]] == [0, 0, 0, 1, 0, 0]
    # each pass visits every clip once: the same sizes for every seed
    for s in (s1, s3):
        for k in range(0, 36, 6):
            assert sorted(v["name"] for v in s[k:k + 6]) == [f"c{i}" for i in range(6)]
    assert [v["visit"] for v in s1] == list(range(40))
    with pytest.raises(ValueError):
        corpus.plan_stream(pool, 1, warmup=3, visits=10)


def test_links_have_names_of_their_own(tmp_path):
    pool = {"clips": [{"name": "c0", "frames": 10, "geometry": 0, "path": str(tmp_path / "x")}]}
    (tmp_path / "x").write_bytes(b"")
    stream = corpus.plan_stream(pool, 1, warmup=1, visits=3)
    paths = corpus.link_stream(stream, str(tmp_path / "s"))
    assert len(set(paths)) == 3 and all(os.path.realpath(p) == str(tmp_path / "x") for p in paths)
