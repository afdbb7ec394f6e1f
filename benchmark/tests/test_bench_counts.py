"""The operation and byte counts against values worked out by hand."""

from benchmark import counts

MNIST = [784, 128, 10]
DEEP = [784, 256, 128, 64, 10]
N = 60_000


def test_parameter_counts():
    assert counts.n_params(MNIST) == 101_770
    assert counts.n_params(DEEP) == 242_762


def test_value_and_gradient_flops():
    # forward 2N(784*128 + 128*10), weight gradients the same, the hidden
    # layer's input gradient 2N*128*10: 4N*100,352 + 6N*1,280
    assert counts.vag_flops(MNIST, N) == 4 * N * 100_352 + 6 * N * 1_280 == 24_545_280_000
    # 4N*242,304 + 2N*(32,768 + 8,192 + 640)
    assert counts.vag_flops(DEEP, N) == 63_144_960_000
    assert counts.vag_flops(MNIST, 256) == 4 * 256 * 100_352 + 6 * 256 * 1_280
    assert counts.hvp_flops(MNIST, 128) == 2 * counts.vag_flops(MNIST, 128)


def test_forward_flops_and_the_trial():
    assert counts.forward_flops(MNIST, N) == 2 * N * 101_632
    # a trial needs the layers above the first: 2N*128*10
    assert counts.forward_flops(MNIST, N, first_layer=False) == 153_600_000
    assert counts.forward_flops(DEEP, N, first_layer=False) == 2 * N * 41_600


def test_two_loop_counts():
    n, m = 101_770, 10
    n_pad = 101_888  # 796 rows of 128
    assert counts.two_loop_bytes(n, m) == 2 * m * n_pad * 4 + 2 * n * 4 + m * 4 == 8_965_240
    assert counts.two_loop_bytes(n, m, pair_bytes=2) == 2 * m * n_pad * 2 + 2 * n * 4 + m * 4
    assert counts.two_loop_flops(n, m) == 4 * n * 21
    assert counts.two_loop_flops(n, 0) == 0
    # the deep ring: 2 * 100 * 242,816 f32 values, 194.3 MB
    assert counts.two_loop_bytes(242_762, 100) == 194_252_800 + 2 * 242_762 * 4 + 400


def test_lbfgs_solve_flops_from_counters():
    # 3 iterations with 5 objective evaluations and 4 gradients: one trial
    # beyond the accepted points, directions over 0, 1, 2 pairs at m = 10
    got = counts.lbfgs_flops(counts.MLPWork(tuple(MNIST)), N, 10, 3, 5, 4)
    want = (4 * 24_545_280_000 + 153_600_000
            + 4 * 101_770 * (2 * (0 + 1 + 2) + 3))
    assert got == want
    # a full history: iteration k uses min(k, m) pairs
    assert counts._pairs_sum(15, 10) == sum(min(k, 10) for k in range(15))


def test_stochastic_flops():
    b, b_h, L, m = 256, 128, 10, 10
    m_inner = N // b  # 234
    nb = (m_inner - 1) // L  # 23 pair steps an epoch
    work = counts.MLPWork(tuple(MNIST))
    # one epoch: no pair before the first average, then one more after
    # each pair step from step 20 on, up to m (held before step t:
    # (t - 1) // 10 - 1)
    one = sum(min(max(min((t - 1) // L, nb) - 1, 0), m) for t in range(1, m_inner))
    assert counts.slbfgs_solve_flops(work, N, b, b_h, L, m, 1) == (
        2 * 24_545_280_000 + 2 * m_inner * counts.vag_flops(MNIST, b)
        + nb * counts.hvp_flops(MNIST, b_h) + 4 * 101_770 * (2 * one + m_inner))
    # the second epoch holds 10 pairs from the start: one full value and
    # gradient more (its anchor's, the first epoch's record), no recomputation
    two = counts.slbfgs_solve_flops(work, N, b, b_h, L, m, 2)
    assert two - counts.slbfgs_solve_flops(work, N, b, b_h, L, m, 1) == (
        24_545_280_000 + 2 * m_inner * counts.vag_flops(MNIST, b)
        + nb * counts.hvp_flops(MNIST, b_h) + 4 * 101_770 * (2 * m * m_inner + m_inner))
    assert counts.slbfgs_solve_flops(work, N, b, b_h, L, m, 0) == 0
    # 234 batches of 256 and the tail of 96, then the recorded full pass
    assert counts.sgd_epoch_flops(counts.MLPWork(tuple(DEEP)), N, 256) == (
        234 * counts.vag_flops(DEEP, 256) + counts.vag_flops(DEEP, 96)
        + 63_144_960_000)


def test_mlp_work_is_the_functions():
    work = counts.MLPWork(tuple(DEEP))
    assert work.n_params == 242_762
    assert work.vag(N) == counts.vag_flops(DEEP, N)
    assert work.trial(N) == counts.forward_flops(DEEP, N, first_layer=False)
    assert work.hvp(128) == counts.hvp_flops(DEEP, 128)
    assert work.vag_bytes(256) == counts.vag_bytes(DEEP, 256)
