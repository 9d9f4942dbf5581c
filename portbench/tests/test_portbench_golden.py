"""The model families' weights and counts, recorded before the families
moved out of core/ (sha256 of each leaf's float32 bytes on the CPU, and
each count as it was): make_params gives the same bits, and every count
the same number of the same type."""

from __future__ import annotations

import hashlib
import json

import pytest
import torch

from portbench.core import inputs, specs, work
from portbench.reference.train import flatten
from portbench.tests.conftest import CELLS, ROOT

PARAMS = {
    "mlp_h128/0": {
        "W1": "ef6eab2995714c8c5e1d6176755a0c4c231f238d28c30c9ac3fb6920844eb158",
        "W2": "09691b399e4f74a920b9c9e37d3f7f5583a56ac90eb51b8ef1fc1312aecaab95",
        "b1": "9d716c20dad665986a6b7791d88ecaf03cdc688ce5b5ab439b8e94a24304b208",
        "b2": "63343636656696d0211dc46442910b0ccaf08187af4f01460c5734f8debc1aff",
    },
    "mlp_h128/1": {
        "W1": "5176487d83ac91b1f8ecea2fa9baa7de8feedb5272a0f4de48a9525604968c39",
        "W2": "44253f39fbc04142d8aa87951d8f4a63e59b5416d716e589b0aa38bcad325886",
        "b1": "9dac9b3ad416652616fe25efa8abb50051473ee4abc63e0b5e8fbdb098bf1c37",
        "b2": "802a05ad5f64866ad140a3b80bd8e0dab3bd232daa1a930c54365e3c78eea316",
    },
    "ngp_hash_l16/0": {
        "W1": "0bcfa512bcba6c96a7a637d8850799bceb048aadd8b8c05db35e4b5d324e06a1",
        "W2": "d730aa7cfa56e4039fabfcfac4ff2c6c554c8b327a6777efa4bd5dbfd3685756",
        "b1": "5341e6b2646979a70e57653007a1f310169421ec9bdd9f1a5648f75ade005af1",
        "b2": "374708fff7719dd5979ec875d56cd2286f6d3cf7ec317a3b25632aab28ec37bb",
        "tables/dense/l10": "b96a0378d386d1ed776d7b4b4fa9ff364bf393533c24f679a196c7a477c7c672",
        "tables/dense/l11": "5bf037cd35d3a269bfa76dd12527b1ab57f1cdfce64b16d5004779d37b4ce445",
        "tables/dense/l12": "41ba988030815e792ac0e0b02007088b761626fbfd52a290a9796f96acfbef33",
        "tables/dense/l13": "907c8fe4d211102cebe92cd660299a1fb5047b5bdabc1a23fef94da4c8b16e2f",
        "tables/dense/l14": "122404b2ebe0a2a63b097df912f210c89b47dc50b1e3ad7d1cae399ec93d7c42",
        "tables/dense/l15": "b5e354fa332d50db1905188bed51ad9527b286a34c99ee747c4dd4415e72596f",
        "tables/dense/l3": "44e9422b1ab26e835dc3a3501847568d534dbd57c64fa972757d22603e2ce42b",
        "tables/dense/l4": "bfd5fa71f9cae50453b1758b55b13554be6b0647de6233cf25774523987e61fe",
        "tables/dense/l5": "259249c7597ded08fb1341b47ba32d582eea8e68390c68a2f5c816c64ac27a32",
        "tables/dense/l6": "76c67abccf018256b354ae3f4ac85a5391c9cecc60d92d9b0308e5c70b4b1acd",
        "tables/dense/l7": "a062b60ea0c5c035ebe9a1917e450ba5e29f6ec73ba73fbf20e5baa32555d46b",
        "tables/dense/l8": "143c815d298262900fd03eaded87499da3abcee67c7d3869f304426eb92456f8",
        "tables/dense/l9": "aab2e0b73a6e0be339ed2f9eae7ed9c5568348b73c9d54d925a504652ec7d524",
        "tables/hash": "5d05deb1cc41916dee3031ad989e2bbb7846f971541ebf39e4fadece82596587",
    },
    "ngp_hash_l16/1": {
        "W1": "d1e0bd257e93e4db62269243cad42569de50a8a16fcc01ce8d860ac6b77a94dd",
        "W2": "0006d538446d48b6f2ab78e6dc7c6c51eb01632e7701b23df1f037be62eb7c45",
        "b1": "5341e6b2646979a70e57653007a1f310169421ec9bdd9f1a5648f75ade005af1",
        "b2": "374708fff7719dd5979ec875d56cd2286f6d3cf7ec317a3b25632aab28ec37bb",
        "tables/dense/l10": "b17b4c6f771a16d375d10db378b0b887c5c20f41639b32deb8593f4b321bfc35",
        "tables/dense/l11": "0fed056db65aeb47680250c3b2c684f3107743ef3180cbb22c9ed3d8dd794264",
        "tables/dense/l12": "e6b3e2fefece08b0fceac6fdb6274b2b671f610b5ff98d7270751cc48c6f9b40",
        "tables/dense/l13": "fa83c91ad15c916f950f68cf71d87981c7ff5fb09c87a5fd8c140a2fdb4e6d65",
        "tables/dense/l14": "ff00f646d5fb50456756668ed4ae67bb1ce8d6be12aaf06b31800eb8caf851b4",
        "tables/dense/l15": "ed0b0f3a12c63fe20dea4a0ee0e5ecebe974c7b083827e411522b0121c7f6444",
        "tables/dense/l3": "fdbba319812a5b8160161596c068f4841e215158e00aa948f6c26ee49e3ef08a",
        "tables/dense/l4": "5726cd0294d3c246494fdbbade3bf6efe40d44581f6dcc69a567cb98fc842c2a",
        "tables/dense/l5": "80ae7130b93063b9b3e03bafbd12ab792612ee450ac516b4bb20d9fdfe1c34db",
        "tables/dense/l6": "59a6f52b201d89f783814872e108275b8cbde0727bb6e80e07b5d2e5d53e0b9a",
        "tables/dense/l7": "0598a7c4fc06ae60bfc0afa906a8208119399c1d3806f6ac24ebe913af549800",
        "tables/dense/l8": "351d606ef5678c075a1473c5874e70ecbd8bf86742e1f4fd7348e8ece65c0fbf",
        "tables/dense/l9": "3ff2a492c69a8e8128c3b1413fd07ef5dfa77b517e6c28dcf705defe3b7ea2c5",
        "tables/hash": "b7d775af72858e44c98fefe89ce1338f7ad5f103b929d87f3670903b4d31298c",
    },
}

#: cell: (params_count, kernel_work of each kernel, unit_flops of each loop).
COUNTS = {
    "mlp_train_256": (1156,
        {"K4": (67900424, 168510357504), "K5": None, "K7": None,
         "grid_forward": (268435456, 21474836480)},
        {"train": 168578463280, "fit": None, "serve": 21474836480}),
    "ngp_train_256": (80198090,
        {"K4": None, "K5": (4294986804, 287695699968), "K7": (4563422252, 236609077248),
         "grid_forward": None},
        {"train": 294518741368.0, "fit": 243432118648.0, "serve": None}),
    "mlp_serve_256": (1156,
        {"K4": (67900424, 168510357504), "K5": None, "K7": None,
         "grid_forward": (268435456, 21474836480)},
        {"train": 168578463280, "fit": None, "serve": 21474836480}),
    "ngp_fit_256": (80198090,
        {"K4": None, "K5": (4294986804, 287695699968), "K7": (4563422252, 236609077248),
         "grid_forward": None},
        {"train": 294518741368.0, "fit": 243432118648.0, "serve": None}),
}


@pytest.mark.parametrize("key", sorted(PARAMS))
def test_make_params_gives_the_recorded_bits(key):
    name, seed = key.split("/")
    config = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    params = inputs.make_params(config, int(seed), torch.device("cpu"))
    got = {path: hashlib.sha256(leaf.detach().to(torch.float32).contiguous().numpy().tobytes()).hexdigest()
           for path, leaf in flatten(params)}
    assert got == PARAMS[key]


def _numbers(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _numbers(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _numbers(v)]
    return [tree]


@pytest.mark.parametrize("cell", CELLS)
def test_the_counts_are_the_recorded_numbers(cell):
    config = specs.load_cell(ROOT, cell).config
    want = COUNTS[cell]
    got = (work.params_count(config), {k: work.kernel_work(k, config) for k in want[1]},
           {loop: work.unit_flops(loop, config) for loop in want[2]})
    assert got == want
    assert [type(v) for v in _numbers(got)] == [type(v) for v in _numbers(want)]  # an int stays an int
