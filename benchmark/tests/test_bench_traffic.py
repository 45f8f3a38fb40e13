"""Each traffic generator is deterministic per seed, varies with it, and
matches the repository's generator it copies."""

import numpy as np

from benchmark.traffic import mnist_images, tile_slides

P = {"n_images": 6, "width": 300, "height": 300, "n_noise": 8,
     "train": True}


def _same(a, b):
    return all(np.array_equal(x["input"][0], y["input"][0])
               and np.array_equal(x["input"][1], y["input"][1])
               and x["majority"] == y["majority"] for x, y in zip(a, b))


def test_mnist_images_per_seed():
    big = 2 ** 31 + 12345
    a, b = mnist_images.make_images(P, big), mnist_images.make_images(P, big)
    assert _same(a, b)
    assert not _same(a, mnist_images.make_images(P, big + 1))


def test_mnist_images_copy_the_repository_generator():
    from ips_tpu_torch.data import mnist
    d, lab = mnist.load_digit_bank("sklearn", train=True)
    d2, lab2 = mnist_images.digit_bank(train=True)
    assert np.array_equal(d, d2) and np.array_equal(lab, lab2)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    assert np.array_equal(mnist._make_noise_patterns(r1, 8),
                          mnist_images.noise_bank(r2, 8))
    bank = mnist_images.noise_bank(np.random.default_rng(1), 8)
    for _ in range(3):
        s1 = mnist._make_sample(r1, d, lab, 300, 300, bank, 8)
        s2 = mnist_images.make_image(r2, d2, lab2, 300, 300, bank, 8)
        assert _same([s1], [s2]) and np.array_equal(s1["multi"],
                                                    s2["multi"])


def test_dense_patches_match_the_repository_patchify():
    from ips_tpu_torch.data.patchify import patchify
    im = mnist_images.make_images(P, 3)[0]
    img = np.zeros(300 * 300, np.float32)
    img[im["input"][0]] = im["input"][1]
    want = patchify(img.reshape(300, 300, 1), (50, 50), (50, 50))
    assert np.array_equal(mnist_images.dense_patches(im, (300, 300),
                                                     (50, 50)), want)


def test_tile_slides_copy_the_repository_generator():
    from ips_tpu_torch.data.camelyon.patches import synth_tile_slides
    p = {"n_slides": 4, "min_tiles": 5, "max_tiles": 11, "tile": [8, 8],
         "pool": 6, "shift": 40}
    seed = 2 ** 31 + 77
    ours = tile_slides.make_slides(p, seed)
    assert sorted(len(t) for t, _ in ours.values()) == [5, 7, 9, 11]
    order = [len(ours[k][0]) for k in sorted(ours)]
    theirs = synth_tile_slides(order, (8, 8), seed, 40, 6)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert np.array_equal(ours[k][0], theirs[k][0])
        assert ours[k][1] == theirs[k][1]
    again = tile_slides.make_slides(p, seed)
    assert all(np.array_equal(again[k][0], ours[k][0]) for k in ours)
    other = tile_slides.make_slides(p, seed + 1)
    assert any(not np.array_equal(other[k][0][:5], ours[k][0][:5])
               for k in ours)
