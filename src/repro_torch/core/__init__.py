"""The batch pipeline (predict -> place -> run -> attribute -> learn):

- scheduler: MHRA on the fused window greedy, ``SoAState``
- policy:    placement policies registrable by name
- executor:  batch executor over the testbed simulator
- testbed:   discrete-event simulator of the paper's Table-I testbed
"""
