"""The batch pipeline (predict -> place -> run -> attribute -> learn):

- scheduler:  MHRA and Cluster MHRA (the fused window greedy, or the
              SoA engine for clustered and multi-input windows), the
              Round-Robin / single-site baselines, ``SoAState``
- carbon, dag, faults, fairness: the scoring registers' snapshots
              (grid carbon rates, DAG lookahead weights, warm-pool
              penalties, user debts) and what they are taken from
- clustering: agglomerative task clustering for Cluster MHRA
- policy:     placement policies registrable by name
- executor:   batch executor over the testbed simulator
- testbed:    discrete-event simulator of the paper's Table-I testbed
"""
