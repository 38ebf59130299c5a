"""The benchmark's plain reference (numpy and plain torch): the map the
generated inputs must produce (:mod:`.awlww`), the frozen digest mix
(:mod:`.digest`) and the comparison that decides ``correct``
(:mod:`.compare`). Nothing here imports the program."""
