"""Reference corpus for the SA-score fragment-frequency table.

The reference SA scorer (DiffPhar/analysis/SA_Score/sascorer.py) loads
fpscores.pkl.gz — log-frequency scores of Morgan radius-2 fragments over a
~1M-molecule PubChem slice. That database isn't shipped here, so the
fragment table is derived at first use from this embedded corpus of ~220
marketed drugs and ubiquitous drug-like scaffolds/fragments: common
environments (aromatic CH, aliphatic chains, amides, esters, basic amines,
the standard N/O/S heterocycles) dominate it the same way they dominate
PubChem, which is what the fragment term actually measures. Environments
absent from the corpus get the reference's unknown-fragment default (-4).

Molecules that fail to parse in the built-in chem core are skipped at
table-build time (the list is validated by tests/test_descriptors.py).

A copy of ``cmdgen_tpu/chem/sa_corpus.py``.
"""

# fmt: off
SA_CORPUS = [
    # --- marketed small-molecule drugs (diverse therapeutic classes)
    "CC(=O)Oc1ccccc1C(=O)O",                      # aspirin
    "CC(C)Cc1ccc(C(C)C(=O)O)cc1",                 # ibuprofen
    "CC(=O)Nc1ccc(O)cc1",                         # paracetamol
    "Cn1cnc2c1c(=O)n(C)c(=O)n2C",                 # caffeine
    "COc1ccc2cc(C(C)C(=O)O)ccc2c1",               # naproxen
    "OC(=O)Cc1ccccc1Nc1c(Cl)cccc1Cl",             # diclofenac
    "Cc1ccc(-c2cc(C(F)(F)F)nn2-c2ccc(S(N)(=O)=O)cc2)cc1",  # celecoxib
    "CCCc1nn(C)c2c(=O)[nH]c(-c3cc(S(=O)(=O)N4CCN(C)CC4)ccc3OCC)nc12",  # sildenafil
    "CC(C)c1c(C(=O)Nc2ccccc2)c(-c2ccccc2)c(-c2ccc(F)cc2)n1CCC(O)CC(O)CC(=O)O",  # atorvastatin
    "CN1CCC(CC1)=C1c2ccccc2CCc2ccccc21",          # amitriptyline-like
    "CN(C)CCCN1c2ccccc2CCc2ccccc21",              # imipramine
    "NC(=O)c1ccc(N)cc1",                          # aminobenzamide
    "Clc1ccccc1-c1nc2ccccc2[nH]1",                # clemizole core
    "CN1CCN(CC1)c1ccc2nc(-c3ccccc3)[nH]c2c1",
    "OCCN1CCN(CCCN2c3ccccc3Sc3ccc(Cl)cc32)CC1",   # perphenazine-like
    "CC(N)Cc1ccccc1",                             # amphetamine
    "CNC(C)Cc1ccccc1",                            # methamphetamine-like
    "NC(Cc1ccc(O)c(O)c1)C(=O)O",                  # DOPA
    "NCCc1ccc(O)c(O)c1",                          # dopamine
    "CNCC(O)c1ccc(O)c(O)c1",                      # epinephrine
    "CC(C)NCC(O)COc1ccccc1CC=C",                  # alprenolol
    "CC(C)NCC(O)COc1ccc(CC(N)=O)cc1",             # atenolol
    "CC(C)NCC(O)COc1cccc2ccccc12",                # propranolol
    "CCOC(=O)c1ccccc1N",                          # benzocaine-like
    "CCN(CC)CC(=O)Nc1c(C)cccc1C",                 # lidocaine
    "COC(=O)C1C2CCC(CC1OC(=O)c1ccccc1)N2C",       # cocaine
    "CN1C2CCC1CC(OC(=O)C(CO)c1ccccc1)C2",         # atropine
    "Oc1ccc2c(c1)OC1C(O)C=CC3C(C2)N(C)CCC31",     # morphine-like
    "COc1ccc2c(c1)OC1C(O)C=CC3C(C2)N(C)CCC31",    # codeine-like
    "CN1CCC23c4c5ccc(O)c4OC2C(=O)CCC3C1C5",       # oxymorphone core
    "CC(=O)OC1CCC2(C)C(=CC(=O)C3C2CCC2(C)C3CCC2(O)C(C)=O)C1",  # steroid-like
    "CC12CCC3c4ccc(O)cc4CCC3C1CCC2O",             # estradiol
    "CC12CCC(=O)C=C1CCC1C2CCC2(C)C1CCC2O",        # testosterone
    "CC(=O)C1CCC2C3CCC4=CC(=O)CCC4(C)C3CCC12C",   # progesterone
    "NC1=NC(=O)c2ncn(COCCO)c2N1",                 # acyclovir-like
    "Nc1nc2c(ncn2COC(CO)CO)c(=O)[nH]1",           # ganciclovir-like
    "CC(N)C(=O)O", "NCC(=O)O",                    # ala, gly
    "NC(CC(=O)O)C(=O)O",                          # asp
    "NC(CCC(=O)O)C(=O)O",                         # glu
    "NC(Cc1ccccc1)C(=O)O",                        # phe
    "NC(Cc1c[nH]c2ccccc12)C(=O)O",                # trp
    "NC(Cc1cnc[nH]1)C(=O)O",                      # his
    "NC(CO)C(=O)O", "NC(CS)C(=O)O",               # ser, cys
    "CC(C)CC(N)C(=O)O", "CCC(C)C(N)C(=O)O",       # leu, ile
    "NCCCCC(N)C(=O)O",                            # lys
    "NC(=N)NCCCC(N)C(=O)O",                       # arg
    "OC(=O)C1CCCN1",                              # pro
    "Nc1ccc(S(N)(=O)=O)cc1",                      # sulfanilamide
    "CC1=CC(=O)N(c2ccccc2)N1C",                   # antipyrine-like
    "Cc1onc(-c2ccccc2)c1C(=O)Nc1ccc(S(N)(=O)=O)cc1",
    "COc1cc2nc(N3CCN(C(=O)C4COc5ccccc5O4)CC3)nc(N)c2cc1OC",  # doxazosin
    "Clc1ccc2nc(N3CCNCC3)c(-c3ccccc3)nc2c1",
    "CN1CCN(C2=Nc3ccccc3Nc3ccccc32)CC1",          # clozapine-like
    "Cc1ccsc1-c1ccc2c(c1)N(CCN1CCOCC1)c1ccccc1S2",
    "OC(c1ccc(F)cc1)(c1ccc(F)cc1)C1CCNCC1",
    "Fc1ccc(C(OCCCN2CCC(O)CC2)c2ccc(F)cc2)cc1",
    "CC(C)(C)NCC(O)c1ccc(O)c(CO)c1",              # salbutamol
    "CNCC(O)c1cccc(O)c1",                         # phenylephrine-like
    "CC(C)(C)NCC(O)COc1ccc(O)c(C(N)=O)c1",
    "CCCCC1(CC)C(=O)NC(=O)NC1=O",                 # barbiturate
    "O=C1NC(=O)C(c2ccccc2)(c2ccccc2)N1",          # phenytoin
    "CCC1(c2ccccc2)C(=O)NC(=O)NC1=O",             # phenobarbital
    "NC(=O)C1(c2ccccc2)CCN(CCc2ccc3c(c2)OCO3)CC1",
    "O=C(N1CCCC1)N1CCCC1",
    "CN(C)C(=O)Nc1ccc(Cl)c(Cl)c1",                # diuron-like urea
    "COC(=O)Nc1nc2ccc(C(=O)c3ccccc3)cc2[nH]1",    # mebendazole
    "CCOC(=O)Nc1nc2ccc(S(=O)c3ccccc3)cc2[nH]1",
    "Clc1ccc(C(c2ccccc2)N2CCN(CCOCCO)CC2)cc1",    # hydroxyzine
    "Clc1ccc(C(c2ccccc2)N2CCN(Cc3ccccc3)CC2)cc1",
    "CN(C)CCOC(c1ccccc1)c1ccccc1",                # diphenhydramine
    "CN(C)CCCC1(c2ccc(F)cc2)OCc2cc(C#N)ccc21",    # citalopram
    "CNCCC(Oc1ccc(C(F)(F)F)cc1)c1ccccc1",         # fluoxetine
    "CNCCC=C1c2ccccc2CCc2ccccc21",                # nortriptyline
    "ClC1=CC2=C(C=C1)N(C)C(=O)CN=C2c1ccccc1",     # diazepam
    "OC1N=C(c2ccccc2)c2cc(Cl)ccc2NC1=O",          # oxazepam-like
    "CC(CN1c2ccccc2Sc2ccccc21)N(C)C",             # promethazine
    "CCN(CC)CCNC(=O)c1ccc(N)cc1",                 # procainamide
    "COc1ccc(CCN(C)CCCC(C#N)(C(C)C)c2ccc(OC)c(OC)c2)cc1OC",  # verapamil
    "CCOC(=O)C1=C(C)NC(C)=C(C(=O)OC)C1c1ccccc1[N+](=O)[O-]",  # nifedipine-like
    "Cc1ncc([N+](=O)[O-])n1CCO",                  # metronidazole
    "NC(=O)c1ncn(C2OC(CO)C(O)C2O)n1",           # (skip-tolerant junk guard)
    "OCC1OC(n2cnc3c(N)ncnc32)C(O)C1O",            # adenosine
    "OCC1OC(n2ccc(=O)[nH]c2=O)CC1O",              # deoxyuridine
    "Cc1cn(C2CC(O)C(CO)O2)c(=O)[nH]c1=O",         # thymidine
    "NC(=O)c1ccc[n+](C2OC(COP(=O)(O)O)C(O)C2O)c1",  # NMN-like
    "OC(=O)c1cc(O)c(O)c(O)c1",                    # gallic acid
    "Oc1cc(O)c2c(c1)OC(c1ccc(O)c(O)c1)C(O)C2",    # catechin
    "COc1cc(C=CC(=O)O)ccc1O",                     # ferulic acid
    "CC(C)=CCc1c(O)cc(O)c2c1OC(c1ccc(O)cc1)CC2=O",  # prenyl-flavanone
    "OC(=O)C=Cc1ccccc1",                          # cinnamic acid
    "CC(C)C1CCC(C)CC1O",                          # menthol
    "CC1=CCC(CC1)C(C)(C)O",                       # terpineol
    "CC(=O)OCC1OC(OC2C(O)C(O)OC(CO)C2O)C(O)C(O)C1O",  # sugar ester
    "OCC1OC(O)C(O)C(O)C1O",                       # glucose
    "OCC(O)C(O)C(O)C(O)CO",                       # sorbitol
    "OC(=O)C(O)C(O)C(=O)O",                       # tartaric acid
    "OC(=O)CC(O)(CC(=O)O)C(=O)O",                 # citric acid
    "CCCCCCCCCCCCCCCC(=O)O",                      # palmitic acid
    "CCCCCCCCC=CCCCCCCCC(=O)O",                   # oleic acid
    "CCCCCCCCCCCCCCCC(=O)OCC(O)CO",               # monoglyceride
    "CCCCCCCCCCCCCCCCN(C)C",                      # fatty amine
    "OCCN(CCO)CCO",                               # triethanolamine
    "CN1CCCC1c1cccnc1",                           # nicotine
    "Cn1c(=O)c2c(ncn2C)n(C)c1=O",                 # theophylline-like
    "COc1ccc(CC2NCCc3cc(OC)c(OC)cc32)cc1",        # tetrahydroisoquinoline
    "COc1ccc2c(c1)c(CC(=O)O)c(C)n2C(=O)c1ccc(Cl)cc1",  # indomethacin
    "CC(C(=O)O)c1ccc2c(c1)Cc1ccccc1-2",
    "OC(=O)c1ccccc1O",                            # salicylic acid
    "OC(=O)c1ccccc1N",                            # anthranilic acid
    "NS(=O)(=O)c1cc2c(cc1Cl)NC(C(Cl)Cl)NS2(=O)=O",  # thiazide-ish
    "NS(=O)(=O)c1cc2c(cc1C(F)(F)F)NCNS2(=O)=O",
    "CC(=O)Nc1nnc(S(N)(=O)=O)s1",                 # acetazolamide
    "CN1CCCN=C1SCC(=O)O",                       # (guard)
    "Nc1nc(=O)c2nc(CNc3ccc(C(=O)NC(CCC(=O)O)C(=O)O)cc3)[nH]c2[nH]1",  # folate (guard)
    "Cc1c(N)cccc1C(=O)O",
    "CCN1CCC(=C2c3ccccc3Sc3ccccc32)CC1",
    "CN(C)CCN(Cc1cccs1)c1ccccn1",                 # methapyrilene
    "Clc1ccccc1CN1CCc2sccc2C1",                   # ticlopidine
    "COc1ccc(Cl)cc1C(=O)NCCc1ccc(S(=O)(=O)NC(=O)NC2CCCCC2)cc1",  # glyburide
    "CCCCNC(=O)NS(=O)(=O)c1ccc(C)cc1",            # tolbutamide
    "CC(C)(C)c1cc(C(C)(C)C)c(O)c(O)c1",         # (guard)
    "CC(C)(C)c1cc(CO)cc(C(C)(C)C)c1O",            # BHT-like
    "Oc1ccc(Cl)cc1Cc1cc(Cl)ccc1O",                # dichlorophene
    "OCC(NC(=O)C(Cl)Cl)C(O)c1ccc([N+](=O)[O-])cc1",  # chloramphenicol
    "CC1(C)SC2C(NC(=O)Cc3ccccc3)C(=O)N2C1C(=O)O",  # penicillin G
    "CC1(C)SC2C(NC(=O)C(N)c3ccccc3)C(=O)N2C1C(=O)O",  # ampicillin
    "CC(O)C(O)C1CNc2nc(N)nc(O)c2N1",            # (guard)
    "Cc1cccc(C)c1NC(=O)CN(CC(=O)O)CC(=O)O",     # (guard)
    "CCc1ccccc1", "CCCc1ccccc1",              # (guards; dup-safe)
    # --- ubiquitous fragments / scaffolds (high-frequency environments)
    "c1ccccc1", "Cc1ccccc1", "CCc1ccccc1", "c1ccc(-c2ccccc2)cc1",
    "c1ccc2ccccc2c1", "c1ccc2[nH]ccc2c1", "c1ccc2occc2c1", "c1ccc2sccc2c1",
    "c1ccncc1", "c1ccncn1", "c1cncnc1", "c1cc[nH]c1", "c1ccoc1", "c1ccsc1",
    "c1cnc[nH]1", "c1cn[nH]c1", "c1cnn[nH]1", "c1csc(N)n1",
    "c1ccc(O)cc1", "c1ccc(N)cc1", "c1ccc(Cl)cc1", "c1ccc(F)cc1",
    "c1ccc(Br)cc1", "c1ccc(OC)cc1", "c1ccc(C(=O)O)cc1", "c1ccc(C#N)cc1",
    "c1ccc(S(N)(=O)=O)cc1", "c1ccc(C(F)(F)F)cc1", "c1ccc(C(N)=O)cc1",
    "Cn1ccnc1", "Cn1cccn1",
    "C1CCCCC1", "C1CCCC1", "C1CCNCC1", "C1CCOCC1", "C1CNCCN1", "C1COCCN1",
    "CN1CCNCC1", "CN1CCCC1", "C1CCNC1", "O=C1CCCCN1", "O=C1CCCN1",
    "C1CCC2(CC1)CCCC2", "C1CC2CCC1C2", "C1CC2CCC1CC2",
    "CC", "CCC", "CCCC", "CCCCC", "CC(C)C", "CC(C)(C)C", "CCO", "CCCO",
    "CCN", "CCCN", "CCOC", "CCOCC", "CCNC", "CCN(C)C", "CC=CC", "CC#CC",
    "CC(N)=O", "CCC(N)=O", "CC(=O)NC", "CCC(=O)NC", "CC(=O)OC",
    "CCC(=O)OCC", "CC(=O)O", "CCC(=O)O", "CCS", "CCSC", "CS(C)(=O)=O",
    "CNC(N)=O", "CNC(=O)NC", "COC(=O)NC", "CN=C(N)N", "CC(=O)C", "CCC(=O)CC",
    "OCCO", "OCCN", "NCCN", "OCCOC", "ClCCCl", "FC(F)F",
    "CC(C)=O", "CC=O", "OC=O", "NC=O", "COC=O",
    "c1ccc(CNC(=O)c2ccccc2)cc1", "c1ccc(NC(=O)c2ccccc2)cc1",
    "c1ccc(COc2ccccc2)cc1", "c1ccc(CN2CCCC2)cc1",
    "c1ccc(S(=O)(=O)Nc2ccccc2)cc1", "c1ccc(C(=O)N2CCOCC2)cc1",
    "O=C(Nc1ccccc1)N1CCCC1", "O=S(=O)(N1CCCC1)c1ccccc1",
]
# fmt: on
