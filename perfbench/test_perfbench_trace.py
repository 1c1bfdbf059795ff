"""The trace's arithmetic: busy intervals merged, idle gaps named by the
innermost host span open at their middle."""
from perfbench import trace


def test_union_merges_overlaps_in_order():
    assert trace.union_ns([(5, 9), (0, 2), (1, 3), (9, 10)]) == [(0, 3),
                                                                 (5, 10)]


def test_gaps_are_named_by_the_innermost_span():
    spans = [(0, 100, "perfbench.panel"), (10, 40, "perfbench.prep"),
             (60, 70, "perfbench.inner")]
    gaps = [(12, 20), (41, 49), (62, 66), (100, 120)]
    assert trace.name_gaps(gaps, spans) == {
        "perfbench.prep": 8e-9, "perfbench.panel": 8e-9,
        "perfbench.inner": 4e-9, "(outside every span)": 20e-9}


def test_kernel_names_are_shortened():
    assert trace.short_name(
        "void (anonymous namespace)::conv_pool_fwd_kernel<float, 1>(float*)"
    ) == "conv_pool_fwd_kernel"
    assert trace.short_name("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD"


def test_untraced_spans_cost_nothing():
    t = trace.Tracer(False, "cpu")
    with t.span("perfbench.x"):
        pass
    assert t.spans == []
